"""Algorithm selection (port of ``repro.core.autotune``): cost-model priors
over every ported algorithm, and measured calibration persisted as a JSON
:class:`TuningTable` keyed on (topology, collective, dtype, size bucket)
with ``algo#cN@codec`` plan keys — the same JSON and keys as the
reference, so one table loads in both packages. A measurement for the
exact key wins over the prior; codec plans are gated by the caller's
``error_budget`` (0.0 admits lossless plans only).

Measurements come from ``runtime.calibrate`` (timed sweeps) and from
:meth:`Selector.ingest`, which folds telemetry's observed per-plan medians
back into the table.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, Optional, Tuple, Union

from repro_torch.core import compress as _codecs
from repro_torch.core import costmodel
from repro_torch.core import mcoll as _mcoll
from repro_torch.core.costmodel import NetParams
from repro_torch.core.topology import Topology

# ---------------------------------------------------------------------------
# candidate registry: every implemented algorithm, minus infeasible ones
# ---------------------------------------------------------------------------

# algo -> feasibility predicate on the topology
_CONSTRAINTS = {
    "recursive_doubling": lambda topo: (topo.world & (topo.world - 1)) == 0,
}


def candidates(collective: str, topo: Optional[Topology] = None
               ) -> Tuple[str, ...]:
    """Candidate algorithms for ``collective``: the full ``core.mcoll``
    registry (so selector coverage can never drift from what is
    implemented), filtered by feasibility on ``topo``."""
    algos = tuple(_mcoll.algorithms(collective))
    if topo is not None:
        algos = tuple(a for a in algos
                      if _CONSTRAINTS.get(a, lambda t: True)(topo))
    return algos


def size_bucket(nbytes: int) -> int:
    """Power-of-two ceiling bucket for a message size (1 byte minimum)."""
    return 1 << max(0, int(nbytes - 1).bit_length())


# ---------------------------------------------------------------------------
# plan keys: (algorithm, chunk count, codec) -> "algo#cN@codec"
# ---------------------------------------------------------------------------

#: separator between an algorithm name and its chunk count in tuning-table
#: keys ("pip_pipeline#c8"); bare names mean chunks=1, so tables recorded
#: before chunked pipelining landed keep resolving.
PLAN_SEP = "#c"

#: separator before the codec name ("pip_pipeline#c8@int8_block"); absent
#: means codec="none", so pre-compression tables keep resolving.
CODEC_SEP = "@"


def encode_plan(algo: str, chunks: int = 1, codec: str = "none") -> str:
    """Tuning-table key for an (algo, chunks, codec) plan. Defaults are
    omitted, so the key for a plain algorithm is its bare name."""
    key = algo if chunks <= 1 else f"{algo}{PLAN_SEP}{int(chunks)}"
    if codec and codec != _codecs.NONE:
        key = f"{key}{CODEC_SEP}{codec}"
    return key


def decode_plan(key: str) -> Tuple[str, int, str]:
    """Inverse of :func:`encode_plan` (bare algorithm names -> chunks=1,
    codec="none")."""
    base, csep, codec = key.partition(CODEC_SEP)
    algo, sep, c = base.partition(PLAN_SEP)
    return (algo, int(c) if sep else 1, codec if csep else _codecs.NONE)


def predicted_seconds(collective: str, plan_key: str, topo: Topology,
                      nbytes: int) -> Optional[float]:
    """Cost-model seconds for an encoded plan key on ``topo`` — the prior
    the telemetry drift detector reports observed medians against. Returns
    ``None`` for plans that are implemented but not modeled (or whose
    codec name is unknown to this build)."""
    algo, chunks, codec = decode_plan(plan_key)
    try:
        return costmodel.plan_seconds(collective, algo, topo, int(nbytes),
                                      chunks=chunks, codec=codec)
    except (ValueError, KeyError):
        return None


def chunk_candidates(collective: str, algo: str, topo: Topology, nbytes: int,
                     net: NetParams,
                     cap: int = costmodel.MAX_CHUNKS) -> Tuple[int, ...]:
    """Chunk counts worth evaluating for one pair at one message size:
    unchunked, the analytic optimum, and its halved/doubled neighbors
    (selection takes the modeled minimum; calibration measures each)."""
    if not _mcoll.supports_chunks(collective, algo):
        return (1,)
    c = costmodel.optimal_chunks(collective, algo, topo, nbytes, net, cap)
    return tuple(sorted({1, max(1, c // 2), c, min(cap, c * 2)}))


def _integer_dtype(dtype: str) -> bool:
    """True for integer/bool payload dtypes, which must never compress
    lossily (kept string-based: this module is jax-free)."""
    return "int" in dtype or "bool" in dtype


def codec_candidates(collective: str, algo: str,
                     error_budget: float = 0.0,
                     dtype: str = "float32") -> Tuple[str, ...]:
    """Codec names worth evaluating for one (collective, algo) under an
    error budget: always ``"none"`` first; other codecs only when the
    algorithm has a compressed execution AND the codec is admissible for
    the payload domain (``compress.admissible``: bound fits the budget,
    integer-only codecs need integer payloads on non-reducing collectives,
    lossy codecs never touch integer payloads). ``error_budget=0.0`` on a
    float payload therefore yields ``("none",)`` for every pair — the
    selector can never emit a lossy plan — while an integer payload still
    admits the lossless integer packers."""
    if not _mcoll.supports_codec(collective, algo):
        return (_codecs.NONE,)
    return _codecs.for_budget(error_budget, collective,
                              integer_payload=_integer_dtype(dtype))


def plans(collective: str, topo: Topology, nbytes: int,
          net: Optional[Union[str, NetParams]] = None,
          codecs: Optional[Tuple[str, ...]] = None,
          dtype: str = "float32") -> Tuple[Tuple[str, int, str], ...]:
    """(algo, chunks, codec) calibration candidates for one message size:
    every feasible algorithm with chunk-count variants for the pipelined
    ones, plus one codec variant per domain-admissible non-identity codec
    (at chunks=1) for the codec-capable algorithms — lossy codecs for
    float payloads, lossless integer packers for integer ones.
    Calibration measures each; the tuning table stores them under
    :func:`encode_plan` keys."""
    net_p = (costmodel.net_for(topo) if net is None
             else costmodel.resolve_net(net))
    integer = _integer_dtype(dtype)
    out = []
    for algo in candidates(collective, topo):
        for c in chunk_candidates(collective, algo, topo, nbytes, net_p):
            out.append((algo, c, _codecs.NONE))
        if _mcoll.supports_codec(collective, algo):
            cds = codecs if codecs is not None else tuple(
                cd for cd in _codecs.codecs() if cd != _codecs.NONE
                and _codecs.admissible(cd, collective, 1.0, integer))
            for cd in cds:
                out.append((algo, 1, cd))
    return tuple(out)


# ---------------------------------------------------------------------------
# selection results + stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Selection:
    """One resolved choice: which algorithm (at what chunk count for the
    pipelined algorithms, with what codec for the compressed ones), at what
    predicted/measured latency, from which evidence source
    ("prior" | "measured")."""
    collective: str
    algo: str
    seconds: float
    source: str
    net: str
    chunks: int = 1
    codec: str = "none"


@dataclasses.dataclass
class SelectionStats:
    """Counts of resolutions by evidence source, plus per-(collective, algo)
    tallies — the observability face of the subsystem (mirrors
    runtime.cache_stats)."""
    prior: int = 0
    measured: int = 0
    by_choice: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)

    @property
    def total(self) -> int:
        return self.prior + self.measured

    @property
    def measured_fraction(self) -> float:
        return self.measured / self.total if self.total else 0.0

    def note(self, sel: Selection) -> None:
        if sel.source == "measured":
            self.measured += 1
        else:
            self.prior += 1
        key = (sel.collective, sel.algo)
        self.by_choice[key] = self.by_choice.get(key, 0) + 1

    def reset(self) -> None:
        self.prior = self.measured = 0
        self.by_choice.clear()


# ---------------------------------------------------------------------------
# measured calibration: the persisted tuning table
# ---------------------------------------------------------------------------


def topo_key(topo: Topology) -> str:
    """Stable string key for a topology: shape + per-axis link names.

    Unset links are normalized to the default preset's name, so a bare
    ``Topology(N, P)`` and one explicitly carrying the default preset share
    measurements. (Topologies with *different* resolved links key —
    correctly — to different table rows: calibrate with the same link
    metadata you serve with, e.g. via ``Topology.from_mesh``.)
    """
    inter, intra = topo.link_names
    default = costmodel.resolve_net(None).name
    # mirror net_for's fallback order: a missing link borrows the other
    # level's, then the default preset
    if inter == "default":
        inter = intra if intra != "default" else default
    if intra == "default":
        intra = topo.link_names[0] if topo.link_names[0] != "default" \
            else default
    key = f"{topo.n_nodes}x{topo.n_local}/{inter}/{intra}"
    # sub-communicator topologies get a group suffix so groups calibrate
    # in their own namespace (an 8-way TP group and a 2-way DP group never
    # share rows; siblings of identical shape — same tag — do). Root
    # topologies carry no suffix, so pre-group tables keep resolving.
    if topo.group:
        key += f"/g:{topo.group}"
    return key


class TuningTable:
    """Measured algorithm latencies keyed on
    (topology, collective, dtype, size bucket) -> {algo: seconds}.

    JSON-serialisable so calibration survives processes: benchmarks write it
    once per mesh, serving/training load it at startup.
    """

    VERSION = 1

    def __init__(self, entries: Optional[dict] = None):
        # entries[topo_key][collective][dtype][str(bucket)][algo] = seconds
        self.entries: dict = entries or {}
        # bumped on every mutation so selectors can invalidate memos
        self.generation = 0

    def __len__(self) -> int:
        return sum(len(algos)
                   for colls in self.entries.values()
                   for dts in colls.values()
                   for buckets in dts.values()
                   for algos in buckets.values())

    def record(self, topo: Topology, collective: str, dtype: str,
               nbytes: int, algo: str, seconds: float) -> None:
        b = str(size_bucket(nbytes))
        (self.entries.setdefault(topo_key(topo), {})
             .setdefault(collective, {})
             .setdefault(str(dtype), {})
             .setdefault(b, {}))[algo] = float(seconds)
        self.generation += 1

    def lookup(self, topo: Topology, collective: str, dtype: str,
               nbytes: int) -> Optional[Dict[str, float]]:
        """Measured {algo: seconds} for the exact key, else None."""
        try:
            return self.entries[topo_key(topo)][collective][str(dtype)][
                str(size_bucket(nbytes))]
        except KeyError:
            return None

    def merge(self, other: "TuningTable", reduce=None) -> None:
        """Fold another table's measurements in.

        ``reduce=None`` (default) keeps the historical other-wins-on-
        conflict semantics. A callable ``reduce(mine, theirs)`` resolves
        same-key conflicts instead — cross-process calibration merges pass
        ``max`` because an SPMD collective is only as fast as its slowest
        rank, so the pessimistic timing is the honest one.
        """
        for tk, colls in other.entries.items():
            for coll, dts in colls.items():
                for dt, buckets in dts.items():
                    for b, algos in buckets.items():
                        mine = (self.entries.setdefault(tk, {})
                                    .setdefault(coll, {})
                                    .setdefault(dt, {})
                                    .setdefault(b, {}))
                        if reduce is None:
                            mine.update(algos)
                        else:
                            for algo, sec in algos.items():
                                mine[algo] = (float(sec) if algo not in mine
                                              else float(reduce(mine[algo],
                                                                sec)))
        self.generation += 1

    # -- persistence --------------------------------------------------------

    def to_json(self) -> dict:
        return {"version": self.VERSION, "entries": self.entries}

    @classmethod
    def from_json(cls, obj: dict) -> "TuningTable":
        if obj.get("version") != cls.VERSION:
            raise ValueError(f"tuning table version {obj.get('version')!r} "
                             f"!= {cls.VERSION}")
        return cls(entries=obj.get("entries", {}))

    def save(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))

    @classmethod
    def load(cls, path) -> "TuningTable":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))


# ---------------------------------------------------------------------------
# the selector
# ---------------------------------------------------------------------------


class Selector:
    """Resolves (collective, topology, size, dtype) -> algorithm.

    Measured calibration (exact tuning-table key) beats the cost-model
    prior; the prior covers everything else. Per-instance stats record how
    often each source fired and what was chosen.
    """

    def __init__(self, table: Optional[TuningTable] = None):
        self.table = table if table is not None else TuningTable()
        self.stats = SelectionStats()
        # (collective, topo, bucket, dtype, net) -> Selection; selection
        # granularity is the size bucket, so hot loops pay the cost model /
        # table walk once per bucket, not per call. The whole memo is
        # dropped when the table mutates (generation bump), so it stays
        # bounded by the live key set even across repeated recalibration.
        self._memo: Dict[tuple, Selection] = {}
        self._memo_gen = self.table.generation

    def choose(self, collective: str, topo: Topology, nbytes: int,
               net: Optional[Union[str, NetParams]] = None,
               dtype: str = "float32",
               error_budget: float = 0.0) -> Selection:
        """Return the best Selection for one message (memoized per size
        bucket; stats still count every resolution).

        ``error_budget`` is the caller's accuracy contract: only codecs
        whose stated relative-error bound fits the budget are candidates
        (``0.0`` -> lossless plans only — in both the prior enumeration and
        the measured-table filter, so a calibrated lossy entry can never
        leak into an exact caller's plan). Integer/bool payload dtypes
        force the budget to 0.0 — the compressed execution rejects lossy
        codecs on them — but the lossless integer packers (e.g.
        ``zlib_sim``) remain candidates on non-reducing collectives, so
        token/index payloads can still compress bit-exactly."""
        if self._memo_gen != self.table.generation:
            self._memo.clear()
            self._memo_gen = self.table.generation
        budget = 0.0 if _integer_dtype(dtype) else float(error_budget)
        # key on the raw net spec (None/name/NetParams are all hashable);
        # NetParams resolution happens only on a miss, off the hot path
        key = (collective, topo, size_bucket(nbytes), dtype, net, budget)
        hit = self._memo.get(key)
        if hit is not None:
            self.stats.note(hit)
            return hit
        net_p = (costmodel.net_for(topo) if net is None
                 else costmodel.resolve_net(net))
        cands = candidates(collective, topo)
        if not cands:
            raise ValueError(f"no feasible algorithm for {collective} "
                             f"on {topo_key(topo)}")
        measured = self.table.lookup(topo, collective, dtype, nbytes)
        if measured:
            # entries are plan keys ("algo", "algo#c8", "algo@codec", ...):
            # feasibility is a property of the algorithm part; the codec
            # part must fit the error budget (unknown codec names — e.g. a
            # table from a build with extra codecs — are skipped)
            usable = {}
            for k, s in measured.items():
                algo, ch, cd = decode_plan(k)
                if algo not in cands:
                    continue
                try:
                    if not _codecs.admissible(cd, collective, budget,
                                              _integer_dtype(dtype)):
                        continue
                except ValueError:
                    continue
                usable[k] = s
            if usable:
                plan = min(usable, key=usable.get)
                algo, ch, cd = decode_plan(plan)
                sel = Selection(collective, algo, usable[plan], "measured",
                                net_p.name, ch, cd)
                self._memo[key] = sel
                self.stats.note(sel)
                return sel
        best_algo, best_c, best_cd, best_t = None, 1, _codecs.NONE, \
            float("inf")
        for algo in cands:
            try:
                for cd in codec_candidates(collective, algo, budget, dtype):
                    # chunk candidates under the codec's effective wire
                    # beta: compression shifts the pipelining optimum too
                    cnet = costmodel.codec_net(net_p, topo, cd)
                    for c in chunk_candidates(collective, algo, topo,
                                              nbytes, cnet):
                        t = costmodel.plan_cost(collective, algo, topo,
                                                nbytes, net_p, chunks=c,
                                                codec=cd).time
                        # switch only on a STRICT relative improvement:
                        # model near-ties (e.g. a pipelined variant at
                        # chunks=1 vs its unchunked parent, or a codec at
                        # ratio ~1) must resolve deterministically to the
                        # first, simpler candidate — "none" enumerates
                        # first, so ties stay lossless
                        if best_algo is None or t < best_t * (1 - 1e-9):
                            best_algo, best_c, best_cd, best_t = \
                                algo, c, cd, t
            except ValueError:  # implemented but not modeled: skip the prior
                continue
        if best_algo is None:  # nothing modeled — arbitrary but deterministic
            best_algo, best_c, best_cd, best_t = cands[0], 1, _codecs.NONE, \
                float("inf")
        sel = Selection(collective, best_algo, best_t, "prior", net_p.name,
                        best_c, best_cd)
        self._memo[key] = sel
        self.stats.note(sel)
        return sel

    def crossover_table(self, collective: str, topo: Topology,
                        net: Optional[Union[str, NetParams]] = None,
                        sizes: Optional[Iterable[int]] = None,
                        dtype: str = "float32",
                        error_budget: float = 0.0) -> Dict[int, Selection]:
        """Message size -> Selection over a size sweep (the per-(topo,
        collective) crossover table; ``error_budget`` admits codec plans)."""
        sizes = tuple(sizes) if sizes else tuple(2 ** i for i in range(4, 27))
        return {s: self.choose(collective, topo, s, net=net, dtype=dtype,
                               error_budget=error_budget)
                for s in sizes}

    # -- observed-evidence ingestion (telemetry loop closure) ---------------

    def ingest(self, telemetry=None, min_samples: int = 1) -> int:
        """Fold telemetry's observed per-plan medians into the tuning table
        as measured evidence (opt-in: nothing flows back unless called).

        ``telemetry`` is the ``repro_torch.core.telemetry`` module or any object
        with a ``plan_observations()`` iterable of observation records
        (``topo / collective / dtype / nbytes / plan`` plus ``median()``),
        each sample a window that ended in a device wait, as a blocking
        calibration row is. Each
        ingested row goes through :meth:`TuningTable.record`, so the
        generation bump invalidates selection memos and the next
        ``choose()`` resolves from the corrected entries — this is how a
        drifted (or poisoned) table row heals from live observation.
        Returns the number of rows recorded."""
        if telemetry is None:
            from repro_torch.core import telemetry  # lazy: no import cycle
        ingested = 0
        for obs in telemetry.plan_observations():
            if len(obs.samples) < max(1, int(min_samples)):
                continue
            med = obs.median()
            if med is None or med <= 0.0:
                continue
            self.table.record(obs.topo, obs.collective, obs.dtype,
                              obs.nbytes, obs.plan, med)
            ingested += 1
        return ingested

    # -- table persistence passthroughs ------------------------------------

    def load_table(self, path) -> None:
        self.table.merge(TuningTable.load(path))

    def save_table(self, path) -> None:
        self.table.save(path)


_DEFAULT = Selector()


def default_selector() -> Selector:
    """The process-wide selector shared by runtime/moe/train/serve."""
    return _DEFAULT


# ---------------------------------------------------------------------------
# original API, now backed by the default selector
# ---------------------------------------------------------------------------


def choose(collective: str, topo: Topology, nbytes: int,
           net: Optional[Union[str, NetParams]] = None) -> Tuple[str, float]:
    """Return (algo, seconds) minimizing modeled/measured latency."""
    sel = _DEFAULT.choose(collective, topo, nbytes, net=net)
    return sel.algo, sel.seconds


def tuning_table(collective: str, topo: Topology,
                 net: Optional[Union[str, NetParams]] = None,
                 sizes: Optional[Tuple[int, ...]] = None) -> Dict[int, str]:
    """Crossover table: message size -> best algorithm name."""
    table = _DEFAULT.crossover_table(collective, topo, net=net, sizes=sizes)
    return {s: sel.algo for s, sel in table.items()}
