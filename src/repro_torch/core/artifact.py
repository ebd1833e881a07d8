"""Schema of the calibration artifact (a copy of ``repro.core.artifact``:
pure Python, so the port keeps its own verbatim copy of the layout).

The reference's benchmark assembles the artifact from three writers
(``--calibrate`` for the base sections, ``--overlap`` and
``--codec-kernels`` merged in). The port writes the calibrate sections
(:data:`CALIBRATE_SECTIONS` less the benchmark-only ``pipeline_crossover``
and ``compression``) from ``Communicator.calibrate`` rows; ``chip_smoke.py``
builds them on the card and validates them here before writing
``build/calibration_artifact.json``. Both packages accept and reject the
same artifacts with the same messages.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: sections ``--calibrate`` writes in one shot; ``backend`` /
#: ``process_count`` record the runtime the numbers were measured under
#: ("single" vs "multiprocess" — see ``repro.distributed.backend``)
CALIBRATE_SECTIONS: Tuple[str, ...] = (
    "topology", "sizes", "backend", "process_count", "table",
    "latency_rows", "model_vs_measured", "pipeline_crossover",
    "compression")

#: sections merged in by the other modes; a full ``run.py calibrate``
#: artifact carries every section
ALL_SECTIONS: Tuple[str, ...] = CALIBRATE_SECTIONS + (
    "overlap", "codec_kernels")

#: required keys per list-of-rows section
ROW_KEYS = {
    "latency_rows": frozenset(
        {"collective", "algo", "nbytes", "dtype", "seconds", "chunks",
         "codec", "group"}),
    "model_vs_measured": frozenset(
        {"collective", "nbytes", "measured_algo", "measured_us",
         "prior_algo", "prior_us", "agree", "per_plan"}),
    "pipeline_crossover": frozenset(
        {"collective", "algo", "model_crossover_bytes", "model_sweep",
         "measured_us_by_plan"}),
    "compression": frozenset(
        {"codec", "declared_ratio", "achieved_ratio", "stated_rel_bound",
         "achieved_abs_error", "bound_abs_tolerance",
         "model_crossover_vs_lossless_bytes",
         "budget_selection_crossover_bytes"}),
}

#: required keys of each ``model_vs_measured[i]["per_plan"]`` row: every
#: measured plan at that (collective, size) with its model prediction and
#: the signed relative error ``(measured - model) / model``
PER_PLAN_KEYS = frozenset(
    {"plan", "measured_us", "model_us", "signed_rel_err"})

#: required keys of the dict-shaped merged sections
SECTION_KEYS = {
    "table": frozenset({"version", "entries"}),
    "overlap": frozenset(
        {"devices", "topology", "microbench", "amortization",
         "train_step"}),
    "codec_kernels": frozenset(
        {"devices", "block", "slices", "world", "elems_per_slice",
         "fused_codecs", "rows", "traffic_halved", "zlib_sim", "note"}),
}


class ArtifactError(ValueError):
    """The artifact is missing a section or a required row key."""


def _require_keys(what: str, obj: dict, required: Iterable[str]) -> None:
    if not isinstance(obj, dict):
        raise ArtifactError(f"{what} must be a dict, got {type(obj).__name__}")
    missing = sorted(set(required) - set(obj))
    if missing:
        raise ArtifactError(f"{what} is missing keys {missing}")


def validate(data: dict, sections: Optional[Tuple[str, ...]] = None) -> dict:
    """Validate ``data`` against the artifact schema and return it.

    ``sections`` names the sections that must be present (default
    :data:`ALL_SECTIONS` — the shape ``run.py calibrate`` commits);
    ``--calibrate`` alone validates with :data:`CALIBRATE_SECTIONS`.
    Sections present beyond the required set are validated too, so a
    partially-merged artifact can't carry a malformed section unnoticed.
    Raises :class:`ArtifactError` on the first violation.
    """
    required = ALL_SECTIONS if sections is None else tuple(sections)
    _require_keys("artifact", data, required)
    if "topology" in data and not isinstance(data["topology"], str):
        raise ArtifactError("topology must be a string topo key")
    if "backend" in data:
        if not isinstance(data["backend"], str) or not data["backend"]:
            raise ArtifactError("backend must be a non-empty string "
                                "(e.g. 'single', 'multiprocess')")
    if "process_count" in data:
        pc = data["process_count"]
        if not isinstance(pc, int) or isinstance(pc, bool) or pc < 1:
            raise ArtifactError("process_count must be an int >= 1")
    if "sizes" in data:
        if (not isinstance(data["sizes"], list) or not data["sizes"]
                or not all(isinstance(s, int) for s in data["sizes"])):
            raise ArtifactError("sizes must be a non-empty list of ints")
    for name, keys in SECTION_KEYS.items():
        if name in data:
            _require_keys(name, data[name], keys)
    for name, keys in ROW_KEYS.items():
        if name not in data:
            continue
        rows = data[name]
        if not isinstance(rows, list) or not rows:
            raise ArtifactError(f"{name} must be a non-empty list of rows")
        for i, row in enumerate(rows):
            _require_keys(f"{name}[{i}]", row, keys)
    if "model_vs_measured" in data:
        for i, row in enumerate(data["model_vs_measured"]):
            pp = row["per_plan"]
            if not isinstance(pp, list) or not pp:
                raise ArtifactError(
                    f"model_vs_measured[{i}].per_plan must be a non-empty "
                    f"list (one row per measured plan)")
            for j, prow in enumerate(pp):
                _require_keys(f"model_vs_measured[{i}].per_plan[{j}]",
                              prow, PER_PLAN_KEYS)
    return data


def validate_file(path, sections: Optional[Tuple[str, ...]] = None) -> dict:
    """Load + :func:`validate` an artifact JSON file."""
    import json
    import pathlib
    return validate(json.loads(pathlib.Path(path).read_text()),
                    sections=sections)


# ---------------------------------------------------------------------------
# the port's own: calibrate sections from Communicator.calibrate rows
# ---------------------------------------------------------------------------


def calibration_sections(comm, rows, link=None) -> dict:
    """The calibrate sections of the artifact from ``comm.calibrate`` rows
    (``include_splits=True`` rows too): ``topology``, ``sizes``,
    ``backend`` and ``process_count`` (from
    ``distributed.backend.stamp_artifact``: ``"single"`` and 1 in one
    process, ``"multiprocess"`` and the process count under a launched
    process group), ``table``
    (``comm.selector``'s), ``latency_rows`` and ``model_vs_measured``.

    One ``model_vs_measured`` row per (group, collective, size) cell, as the
    reference's benchmark builds it: the lossless measured argmin, the
    prior's choice (a selector with an empty table), ``agree`` when their
    algorithms match, and a ``per_plan`` row for every measured plan with
    its model time and ``signed_rel_err = (measured - model) / model``; the
    port adds ``group``, ``measured_plan`` and ``prior_plan`` (full plan
    keys). ``link`` (a preset name or ``NetParams``) prices the prior and
    the model with that link at both levels instead of the topology's own,
    on the same measured rows."""
    import dataclasses

    from repro_torch.core import autotune  # lazy: the schema is stdlib-only
    from repro_torch.distributed import backend as _backend

    topos = {c.topo.group: c.topo
             for c in (comm,) + tuple(comm.split_lattice())}
    cells = {}
    for r in rows:
        cells.setdefault((r.group, r.collective, r.nbytes, r.dtype),
                         {})[autotune.encode_plan(r.algo, r.chunks,
                                                  r.codec)] = r.seconds
    comparison = []
    for (group, coll, nb, dtype), measured in cells.items():
        topo = topos[group]
        if link is not None:
            topo = topo.with_links(link, link)
        lossless = {k: v for k, v in measured.items()
                    if autotune.decode_plan(k)[2] == "none"}
        best = min(lossless, key=lossless.get)
        prior = autotune.Selector().choose(coll, topo, nb, dtype=dtype)
        per_plan = []
        for plan in sorted(measured):
            meas_s = measured[plan]
            model_s = autotune.predicted_seconds(coll, plan, topo, nb)
            modeled = bool(model_s) and model_s > 0.0
            per_plan.append({
                "plan": plan, "measured_us": meas_s * 1e6,
                "model_us": model_s * 1e6 if modeled else None,
                "signed_rel_err": ((meas_s - model_s) / model_s
                                   if modeled else None)})
        comparison.append({
            "group": group, "collective": coll, "nbytes": nb,
            "measured_algo": autotune.decode_plan(best)[0],
            "measured_plan": best, "measured_us": lossless[best] * 1e6,
            "prior_algo": prior.algo,
            "prior_plan": autotune.encode_plan(prior.algo, prior.chunks,
                                               prior.codec),
            "prior_us": prior.seconds * 1e6,
            "agree": autotune.decode_plan(best)[0] == prior.algo,
            "per_plan": per_plan})
    return _backend.stamp_artifact({
        "topology": autotune.topo_key(comm.topo),
        "sizes": sorted({int(r.nbytes) for r in rows}),
        "table": comm.selector.table.to_json(),
        "latency_rows": [dataclasses.asdict(r) for r in rows],
        "model_vs_measured": comparison})
