"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, no shared expert.
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="decoder",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536))
