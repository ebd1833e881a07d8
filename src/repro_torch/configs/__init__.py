"""Architecture configs ported from the JAX package, all ten of its
assigned architectures: the dense decoders (smollm-360m, yi-34b,
qwen1.5-4b, phi3-medium-14b), the VLM qwen2-vl-72b (M-RoPE, stub patch
embeddings), rwkv6-1.6b, jamba-1.5-large-398b, the MoE family
(qwen3-moe-235b-a22b, arctic-480b) and the encoder-decoder
seamless-m4t-large-v2 (stub frame embeddings)."""
import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, ShapeConfig, \
    SHAPES, shape_applicable

__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "shape_applicable", "ARCH_IDS", "get_config", "reduced_config",
           "first_layers"]

_MODULES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "yi-34b": "yi_34b",
    "qwen1.5-4b": "qwen1_5_4b",
    "phi3-medium-14b": "phi3_medium_14b",
    "smollm-360m": "smollm_360m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's cut: 2
    layers, d_model 128, 4 heads, head_dim 32, d_ff 256, vocab 512)."""
    cfg = get_config(arch)
    pat = cfg.block_pattern
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=8,
                                  top_k=min(moe.top_k, 2), d_ff_expert=64)
    return dataclasses.replace(
        cfg,
        n_layers=len(pat) * (2 if len(pat) == 1 else 1),
        enc_layers=min(cfg.enc_layers, 2),
        d_model=128, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32, d_ff=256, vocab=512, moe=moe, rwkv_head_dim=32)


def first_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut in depth to its first ``n`` layers; every width stays the
    published one. Within one pattern cycle the cut is one cycle of those
    ``n`` kinds (full jamba's first five: mamba+FFN, mamba+MoE twice, then
    attention+FFN); past it, ``n`` must be a whole number of cycles, up to
    ``n_layers`` (qwen3-moe's and arctic's ``("attn",)`` cut to 4 or 1
    layers)."""
    pat = len(cfg.block_pattern)
    if 1 <= n <= pat:
        return dataclasses.replace(cfg, n_layers=n,
                                   block_pattern=cfg.block_pattern[:n])
    if n < 1 or n % pat or n > cfg.n_layers:
        raise ValueError(f"{cfg.name}: cut to {n} layers, not within one "
                         f"cycle of {pat} nor a whole number of cycles up "
                         f"to {cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=n)
