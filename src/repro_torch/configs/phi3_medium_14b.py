"""phi3-medium-14b [dense]: RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="decoder",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352)
