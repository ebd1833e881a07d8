"""Roofline terms per (arch x shape x grid) from the dry run's counts
(port of ``repro.roofline.terms``).

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = HBM bytes per device / HBM bytes/s
  collective term = collective bytes per device / link bytes/s

The reference's constants are a TPU v5e's. Here the hardware is a
:class:`Hardware` passed to :func:`compute_terms`, by default one H100
SXM5 80GB at its 700 W power limit (:data:`H100_SXM`), each peak from
NVIDIA's data sheet. The port's production grids (``launch/mesh.py``: 32
or 64 nodes of 8 GPUs) cross the network on their ``node`` axis in both
cases, so the collective term takes the network's rate on both, where
the reference picks ICI for one pod and DCN for two.

The counts come from ``roofline.counter`` (``launch/dryrun.py`` divides
them into per-device terms); the model FLOPs are the reference's
formulas, unchanged: :func:`model_flops` counts ``cfg.active_params()``,
whose undercount is the reference's (ROADMAP.md, queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks and its links' rates, in FLOP/s and bytes/s."""

    name: str
    peak_flops: float
    hbm_bw: float
    nvlink_bw: float
    net_bw: float


#: one NVIDIA H100 SXM5 80GB at 700 W (NVIDIA H100 Tensor Core GPU data
#: sheet): bf16 dense tensor-core peak 989.4 TFLOP/s (1,978.9 with
#: sparsity, halved); HBM3 3.35 TB/s; fourth-generation NVLink 900 GB/s
#: per GPU both ways together, 450 GB/s each way; between nodes one
#: 400 Gb/s NDR InfiniBand port per GPU, 50 GB/s
H100_SXM = Hardware("H100 SXM5 80GB", 989.4e12, 3.35e12, 450e9, 50e9)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs per device * chips)
    bottleneck: str
    collective_counts: Dict[str, int]

    def total_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction: the time the chips *must*
        spend on model FLOPs against the bound (max term)."""
        ideal = self.compute_s * self.useful_ratio
        return ideal / self.total_s() if self.total_s() > 0 else 0.0


def compute_terms(hlo_flops_per_dev: float, hlo_bytes_per_dev: float,
                  collective_bytes_per_dev: float, chips: int,
                  model_flops_global: float,
                  collective_counts: Optional[Dict[str, int]] = None,
                  link_bw: Optional[float] = None,
                  hw: Hardware = H100_SXM) -> RooflineTerms:
    """The reference's terms on ``hw``; ``link_bw`` (default: ``hw``'s
    network rate) is the collective term's rate."""
    link_bw = hw.net_bw if link_bw is None else link_bw
    compute_s = hlo_flops_per_dev / hw.peak_flops
    memory_s = hlo_bytes_per_dev / hw.hbm_bw
    coll_s = collective_bytes_per_dev / link_bw
    useful = (model_flops_global / (hlo_flops_per_dev * chips)
              if hlo_flops_per_dev else 0.0)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(compute_s, memory_s, coll_s, hlo_flops_per_dev,
                         hlo_bytes_per_dev, collective_bytes_per_dev,
                         model_flops_global, useful, bottleneck,
                         collective_counts or {})


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N*D for
    inference, with N = active params; D = tokens processed this step."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def _n_attn_layers(cfg) -> int:
    pat = cfg.block_pattern
    per_cycle = sum(1 for k in pat if k == "attn")
    return cfg.n_layers // len(pat) * per_cycle


def model_flops_attn(cfg, shape) -> float:
    """Attention score+value matmul FLOPs (excluded from 6ND but real
    work: dominates small-d_model long-seq cells). Causal halves the
    square."""
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.n_heads, cfg.head_dim
    L = _n_attn_layers(cfg)
    if cfg.family == "rwkv":
        # wkv recurrence: ~4 flops per (head_dim^2) per token per layer
        per_tok = 4.0 * cfg.d_model * cfg.rwkv_head_dim * cfg.n_layers
        mult = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[shape.kind]
        toks = B * (S if shape.kind != "decode" else 1)
        return per_tok * toks * mult
    if shape.kind == "train":
        fwd = 2.0 * B * H * S * S * hd * L  # qk+av, causal halved
        extra = 0.0
        if cfg.family == "encdec":
            # enc self (bidir, S/2 each side) + dec cross
            fwd = fwd / 4  # both streams are S//2 long
            Le = cfg.enc_layers
            fwd += 4.0 * B * H * (S // 2) ** 2 * hd * Le / 2
            fwd += 4.0 * B * H * (S // 2) ** 2 * hd * L
        return 3.0 * (fwd + extra)
    if shape.kind == "prefill":
        return 2.0 * B * H * S * S * hd * L
    return 4.0 * B * H * S * hd * L  # decode: 1 token vs S keys


def grid_axes(grid) -> Mapping[str, int]:
    """``{axis: size}`` of a rank grid, a ``Communicator``, or a mapping
    of the port's axes (``node``, ``local``)."""
    if isinstance(grid, Mapping):
        return grid
    return dict(getattr(grid, "grid", grid).shape)


def flash_hbm_traffic(cfg, shape, grid, flags) -> float:
    """Per-device HBM bytes a flash attention kernel streams for the
    cell's attention (K/V read once per query chunk, Q/O once): the
    reference's formula with its mesh axes mapped onto the grid's,
    {``pod``, ``data``} -> ``node`` (data parallel, and the decode cache's
    sequence where the batch is smaller than the node axis, as
    ``launch.mesh.default_rules`` shards it) and ``model`` -> ``local``.
    Train counts forward + remat-recompute + backward (3 passes)."""
    B, S = shape.global_batch, shape.seq_len
    L = _n_attn_layers(cfg)
    if L == 0 or cfg.family == "rwkv":
        return 0.0
    axes = grid_axes(grid)
    dp = axes.get("node", 1)
    tp = axes.get("local", 1)
    B_dev = max(1, B // dp)
    KV, H, hd = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    kv_dev = max(1, KV // tp) if KV % tp == 0 else KV
    h_dev = max(1, H // tp) if H % tp == 0 else H
    if shape.kind == "decode":
        # one-token decode: read the whole (sharded) cache once
        seq_shard = dp if (B < dp) else 1
        return (2.0 * B_dev * (S // seq_shard) * kv_dev * hd * 2) * L
    nq = max(1, S // flags.q_chunk)
    kv_bytes = S * kv_dev * hd * 2 * 2          # K+V bf16
    q_o = 2.0 * S * h_dev * hd * 2
    per_layer = nq * kv_bytes + q_o
    passes = 3.0 if shape.kind == "train" else 1.0
    return per_layer * L * B_dev * passes
