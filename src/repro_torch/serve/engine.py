"""Batched serving engine: continuous prefill + decode over a request queue
(port of ``repro.serve.engine``).

  - requests arrive with a prompt (token array) and ``max_new_tokens``;
  - the engine packs up to ``max_batch`` active sequences into one fixed
    cache per layer: a ``(max_batch, max_len, KV, hd)`` KV buffer for an
    attention layer, the recurrent state of ``max_batch`` slots for an rwkv
    layer;
  - one prefill pass per admitted request fills its slot's cache rows,
    after zeroing the slot's recurrent state (a finished request's state
    is not carried into the next one; the reference's engine carries it);
  - one fused decode tick advances every slot, each at its own length (a
    ``(B,)`` vector of cache indices); finished sequences (EOS or budget)
    free their slot for the next queued request (continuous batching).

Token-level sync across DP replicas is a small-message collective, the
paper's regime. Given a ``RankGrid`` (``mesh=``), the engine binds a
``Communicator`` and syncs each tick's sampled tokens through a
**persistent broadcast op**: the payload is always ``(max_batch,)`` int32,
so the plan (``sync_algo`` under ``sync_error_budget``) is resolved once,
on the first tick (``comm.broadcast_init``), and every later tick is a
bare ``op.start(x).wait()``. The op is rebound when the selector's tuning table
changes generation, with a warning past ``REBIND_WARN_THRESHOLD`` rebinds.
``sync_axes=`` scopes the sync to a group of the grid
(``comm.split(axes=...)``). A world-1 grid or group skips the sync
entirely.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.comm import Communicator, PersistentOp
from repro_torch.core.topology import Topology
from repro_torch.models.decoder import RunFlags

#: sync-plan rebinds (tuning-table generation changes) tolerated silently;
#: past this, one warning names the storm
REBIND_WARN_THRESHOLD = 3


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: Optional[List[int]] = None


class Engine:
    """Serves a ``DecoderLM`` (``model``) on the model's device, greedily
    (argmax).

    ``mesh`` is a ``RankGrid`` on the same device whose ranks are the DP
    replicas the tick tokens are synced across, or a ``ProcessGrid``,
    where each process runs its own engine, one DP replica a process (its
    held rows), with the topology ``topo``
    (default ``Topology.from_grid(mesh)``). ``sync_algo`` pins the tick
    sync's broadcast algorithm or, ``"auto"`` (the default), lets the
    selector pick it; ``sync_error_budget`` is the accuracy knob on that
    plan, passed to the selector's codec gating (integer tokens resolve
    lossless for any budget: lossy codecs are inadmissible on integers).
    ``sync_axes`` (one grid axis or a ``(node, local)`` pair; ignored
    without a mesh) scopes the sync to the sub-communicator
    ``comm.split(axes=sync_axes)``: each group broadcasts from its own
    first rank, and calibration for the sync plan belongs on
    ``self.sync_comm`` (its tuning rows carry the group tag)."""

    def __init__(self, model, cfg, max_batch: int = 8, max_len: int = 256,
                 flags: RunFlags = RunFlags(), mesh=None,
                 topo: Optional[Topology] = None, sync_axes=None,
                 sync_algo: str = "auto", sync_error_budget: float = 0.0):
        self.model = model
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.flags = flags
        self.device = model.device
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"sync grid on {mesh.device}, model on "
                             f"{self.device}")
        self.comm = Communicator(mesh, topo) if mesh is not None else None
        self.topo = self.comm.topo if self.comm is not None else topo
        self.sync_comm = (self.comm.split(axes=sync_axes)
                          if mesh is not None and sync_axes is not None
                          else self.comm)
        self.sync_algo = sync_algo
        self.sync_error_budget = float(sync_error_budget)
        # bound on the first real sync (a world-1 engine never resolves a
        # plan), rebound when the selector's tuning table mutates
        self._sync_op: Optional[PersistentOp] = None
        self._sync_gen: int = -1
        # per-engine observability behind metrics(): host-clock tick
        # latency (around the whole admit + decode + sync tick; no extra
        # device sync), slot occupancy, rebinds
        self._tick_hist = telemetry.Histogram("serve.tick_seconds")
        self._ticks = 0
        self._occupied_slot_ticks = 0
        self.rebinds = 0
        self._rebind_warned = False
        self.caches = model.init_cache(max_batch, max_len)
        self.lengths = np.zeros(max_batch, np.int32)
        self.active: List[Optional[Request]] = [None] * max_batch

    def _sync_tokens(self, nxt: torch.Tensor) -> torch.Tensor:
        """Cross-replica agreement on each slot's next token: a persistent
        small-message broadcast of the ``(max_batch,)`` int32 tick payload;
        returns held row 0, which is rank 0's broadcast copy on every
        process of a ``ProcessGrid`` too (under ``sync_axes``, its group's
        first rank's)."""
        if self.mesh is None or self.sync_comm.topo.world == 1:
            return nxt  # nothing to reconcile; skip the per-tick dispatch
        gen = self.sync_comm.selector.table.generation
        if self._sync_op is None or gen != self._sync_gen:
            # (re)resolve the plan: first tick, or the tuning table changed;
            # release the op being replaced
            if self._sync_op is not None:
                self._sync_op.release()
                self.rebinds += 1
                telemetry.counter("serve.plan_rebinds").inc()
                if (self.rebinds > REBIND_WARN_THRESHOLD
                        and not self._rebind_warned):
                    self._rebind_warned = True
                    warnings.warn(
                        f"engine sync-plan rebind storm: {self.rebinds} "
                        f"rebinds over {self._ticks} ticks (tuning-table "
                        f"generation now {gen}); something is mutating the "
                        f"selector table every few ticks — each rebind "
                        f"releases and re-inits the persistent sync op. "
                        f"See Engine.metrics()['plan_rebinds'].",
                        RuntimeWarning, stacklevel=3)
            self._sync_op = self.sync_comm.broadcast_init(
                nxt, algo=self.sync_algo,
                error_budget=self.sync_error_budget)
            self._sync_gen = gen
        return self._sync_op.start(nxt).wait(block=False)[0]

    def _prefill(self, tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """Prefill one prompt into ``slot``'s cache rows (views of the
        engine's caches, written in place) from a zeroed recurrent state;
        returns the last position's logits."""
        rows = [{name: t[slot:slot + 1] for name, t in c.items()}
                for c in self.caches]
        self.model.reset_state(rows)
        logits, _, _ = self.model(tokens, rows, flags=self.flags)
        return logits[0, -1]

    # slot-at-a-time prefill keeps admission simple; the fused decode tick
    # is the performance-relevant path
    def _admit(self, req: Request, slot: int) -> None:
        T = len(req.prompt)
        if not 0 < T < self.max_len:
            raise ValueError(f"prompt of {T} tokens does not fit a "
                             f"{self.max_len}-position cache")
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        last = self._prefill(tokens, slot)
        self.lengths[slot] = T
        req.out_tokens = [int(last.argmax())]
        self.active[slot] = req

    def _decode_tick(self) -> np.ndarray:
        """One fused decode step of every slot at its own cache index
        (slot b's new KV row lands at ``lengths[b]`` and its attention masks
        to ``lengths[b] + 1``), the greedy pick, and the tick sync; returns
        the ``(max_batch,)`` next tokens."""
        toks = np.zeros((self.max_batch, 1), np.int64)
        for slot, req in enumerate(self.active):
            if req is not None:
                toks[slot, 0] = req.out_tokens[-1]
        index = torch.tensor(self.lengths, device=self.device)
        logits, _, _ = self.model(torch.as_tensor(toks, device=self.device),
                                  self.caches, index, flags=self.flags)
        nxt = logits[:, 0].argmax(-1).to(torch.int32)
        return self._sync_tokens(nxt).cpu().numpy()

    @torch.inference_mode()
    def run(self, requests: List[Request], max_ticks: int = 10000
            ) -> List[Request]:
        queue = list(requests)
        done: List[Request] = []
        ticks = 0
        while (queue or any(self.active)) and ticks < max_ticks:
            ticks += 1
            t_tick = time.perf_counter()
            for slot in range(self.max_batch):
                if self.active[slot] is None and queue:
                    self._admit(queue.pop(0), slot)
            nxt = self._decode_tick()
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                req.out_tokens.append(int(nxt[slot]))
                self.lengths[slot] += 1
                if (len(req.out_tokens) >= req.max_new_tokens or
                        (req.eos_id is not None
                         and req.out_tokens[-1] == req.eos_id)):
                    done.append(req)
                    self.active[slot] = None
            dt = time.perf_counter() - t_tick
            active_n = sum(r is not None for r in self.active)
            self._ticks += 1
            self._occupied_slot_ticks += active_n
            self._tick_hist.observe(dt)
            telemetry.emit("serve/tick", t_tick, dt, cat="serve",
                           active=active_n)
        done.extend([r for r in self.active if r is not None])
        return done

    def metrics(self) -> dict:
        """Per-engine serving metrics: tick-latency distribution (p50/p99
        seconds over every tick this engine has run), mean slot occupancy
        (active slots / max_batch, after retirement), the sync-plan rebind
        count and the persistent sync op's starts."""
        h = self._tick_hist
        return {
            "ticks": self._ticks,
            "tick_p50_s": h.quantile(0.50),
            "tick_p99_s": h.quantile(0.99),
            "tick_mean_s": h.mean,
            "slot_occupancy": (self._occupied_slot_ticks
                               / (self._ticks * self.max_batch)
                               if self._ticks else 0.0),
            "plan_rebinds": self.rebinds,
            "sync_starts": (self._sync_op.starts
                            if self._sync_op is not None else 0),
        }
