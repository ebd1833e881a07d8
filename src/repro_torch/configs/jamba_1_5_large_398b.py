"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. Sub-quadratic -> long_500k runs.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="decoder",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba",
                   "mamba", "mamba"))
