"""The yardstick's frozen formulas: what a kernel must move and compute,
the model FLOPs of a train step, and the card's published peaks.

These are copies, not imports, of what the program registers for itself
(``repro_torch/kernels/codec.py``'s ``encode_cost``/``decode_cost``,
``repro_torch/roofline/terms.py``'s ``H100_SXM`` and
``model_flops_attn``), so that a later change to the program cannot move
the numbers a roofline share is divided by.
"""
from __future__ import annotations

import math

#: one NVIDIA H100 SXM5 80GB at its 700 W power limit, from NVIDIA's H100
#: Tensor Core GPU data sheet (dense rates, no sparsity)
HBM_BYTES_PER_S = 3.35e12      # HBM3
BF16_FLOP_PER_S = 989.4e12     # tensor cores, dense bf16 (1,978.9 sparse)
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
PEAKS_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5 80GB at "
                "700 W: 3.35 TB/s HBM3, 989.4 TFLOP/s dense bf16, 67 "
                "TFLOP/s fp32")

#: elements of one quantization block of the block codecs
BLOCK = 256
#: modeled fp32 operations per element of a block encode (add, abs, max,
#: mul, div, rint, two clips, fma) and per (element, peer) of a
#: decode-reduce (one fma)
ENCODE_OPS_PER_ELEM = 9
DECODE_OPS_PER_ELEM_PEER = 2
#: wire bytes per block
WIRE_BYTES_PER_BLOCK = {"int8": BLOCK, "int4": BLOCK // 2}


def block_encode_cost(codec: str, S: int, L: int, with_err: bool = False):
    """(bytes, ops) of one block encode of ``S`` slices of ``L`` float32
    elements: x (and the carried error) read, the wire, the per-block
    float32 scales and the float32 residual written."""
    nb = -(-L // BLOCK)
    read = 4 * S * L * (2 if with_err else 1)
    nbytes = read + S * nb * WIRE_BYTES_PER_BLOCK[codec] + 4 * S * nb \
        + 4 * S * L
    return nbytes, ENCODE_OPS_PER_ELEM * S * L


def block_decode_reduce_cost(codec: str, R: int, W: int, nb: int,
                             length: int):
    """(bytes, ops) of one decode-reduce of ``R`` ranks' ``W`` peer slices
    of ``nb`` blocks into ``length`` float32 outputs a rank: the wire and
    the scales read, the float32 sum written; one fma per (rank, peer,
    element)."""
    nbytes = R * W * nb * WIRE_BYTES_PER_BLOCK[codec] + 4 * R * W * nb \
        + 4 * R * length
    return nbytes, DECODE_OPS_PER_ELEM_PEER * R * W * length


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the fp32 operations over the fp32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def sync_least_bytes(n_params: int, world: int) -> int:
    """The least HBM traffic of one error-feedback gradient sync step:
    every rank reads its gradient and its carried error and writes its
    result and its new error, 16 bytes a parameter a rank."""
    return 16 * n_params * world


def matmul_params_per_token(cfg: dict) -> int:
    """Weights of the matrix products one token passes through in the
    forward: attention's four projections, the MLP's three or the router
    and the ``top_k`` routed experts' three, and the LM head. The
    embedding lookup and the experts a token is not routed to are left
    out."""
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"]
    attn = D * H * hd * 2 + D * KV * hd * 2
    moe = cfg.get("moe")
    if moe:
        ffn = D * moe["n_experts"] + moe["top_k"] * 3 * D * moe["d_ff_expert"]
    else:
        ffn = 3 * D * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn) + D * cfg["vocab"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step over ``batch`` rows of ``seq`` tokens:
    6 x the matrix-product weights a token passes through x the tokens,
    plus the causal attention's score and value products, forward and
    backward (3 x 2·B·H·S²·hd a layer: the square halved by the mask)."""
    tokens = batch * seq
    attn = 3.0 * 2.0 * batch * cfg["n_heads"] * seq * seq \
        * cfg["head_dim"] * cfg["n_layers"]
    return 6.0 * matmul_params_per_token(cfg) * tokens + attn


def share_pct(least_s: float, measured_s: float):
    """``least_s / measured_s`` in percent, or None when nothing was
    measured."""
    if not measured_s or not math.isfinite(measured_s) or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
