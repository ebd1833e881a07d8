"""Architecture + run-shape configuration objects.

`ModelConfig` fully describes an architecture (one file per assigned arch in
this package). `ShapeConfig` describes an (input-shape) cell from the
assignment: train_4k / prefill_32k / decode_32k / long_500k.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    every: int = 1                # MoE at every k-th block (jamba: 2)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "decoder" | "encdec" | "rwkv"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"            # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    # hybrid block pattern, cycled over layers (jamba: attn + 7 mamba)
    block_pattern: Tuple[str, ...] = ("attn",)
    # mamba (jamba values)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    # enc-dec
    enc_layers: int = 0
    # modality frontend stub: "tokens" | "frames" (audio) | "vl" (vision)
    input_mode: str = "tokens"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # pad q-heads up to a multiple of this (TP alignment; extra heads have
    # zero wq columns + zero wo rows, so outputs are exactly unchanged).
    # Only legal when the padded count stays a multiple of n_kv_heads.
    head_pad: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0 or self.n_kv_heads == 0

    @property
    def padded_heads(self) -> int:
        if not self.head_pad:
            return self.n_heads
        hp = -(-self.n_heads // self.head_pad) * self.head_pad
        assert hp % self.n_kv_heads == 0, \
            f"head padding {self.n_heads}->{hp} breaks GQA grouping " \
            f"(kv={self.n_kv_heads})"
        return hp

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """True when decode-state memory does not grow O(L^2)-attention-style
        with context (SSM / hybrid / linear attention)."""
        return self.family == "rwkv" or "mamba" in self.block_pattern

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += D * V  # lm head
        pattern = self.block_pattern
        n_attn_like = 0
        for i in range(self.n_layers + self.enc_layers):
            kind = pattern[i % len(pattern)]
            total += D  # block norm scale
            if kind == "attn":
                total += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
                if self.qkv_bias:
                    total += (H + 2 * KV) * hd
                n_attn_like += 1
            elif kind == "mamba":
                Di = self.mamba_expand * D
                dt_rank = -(-D // 16)
                total += (D * 2 * Di + self.mamba_d_conv * Di
                          + Di * (dt_rank + 2 * self.mamba_d_state)
                          + dt_rank * Di + Di * self.mamba_d_state + Di
                          + Di * D)
            elif kind == "rwkv":
                total += 6 * D * D + 2 * D * F + D * F // F * 0  # tm + cm
            # ffn/moe per block (attn & mamba blocks both carry one)
            if kind != "rwkv":
                moe = self.moe
                if moe and (i % moe.every == moe.every - 1):
                    total += D * moe.n_experts  # router
                    total += moe.n_experts * 3 * D * moe.d_ff_expert
                    if moe.dense_residual:
                        total += 3 * D * F
                else:
                    total += 3 * D * F
                total += D  # ffn norm
        total += D  # final norm
        if self.family == "encdec":
            # decoder cross-attn per decoder layer
            total += self.n_layers * (D * (H * hd) + 2 * D * (KV * hd)
                                      + (H * hd) * D + D)
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        moe = self.moe
        dense_equiv = dataclasses.replace(self, moe=None)
        full = dense_equiv.n_params()
        # subtract the dense FFN we counted on MoE layers, add router +
        # top_k experts (+ dense residual if present)
        n_moe_layers = sum(
            1 for i in range(self.n_layers + self.enc_layers)
            if self.block_pattern[i % len(self.block_pattern)] != "rwkv"
            and (i % moe.every == moe.every - 1))
        D, F = self.d_model, self.d_ff
        full -= n_moe_layers * 3 * D * F
        full += n_moe_layers * (D * moe.n_experts
                                + moe.top_k * 3 * D * moe.d_ff_expert)
        if moe.dense_residual:
            full += n_moe_layers * 3 * D * F
        return full


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                     # train_4k / prefill_32k / decode_32k / long_500k
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs (per assignment spec)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention arch — O(L^2) attention at "
                       "524288 is the assignment-mandated skip (DESIGN.md)")
    return True, ""
