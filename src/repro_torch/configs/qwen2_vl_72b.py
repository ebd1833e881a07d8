"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; vision frontend stubbed
as precomputed patch embeddings per assignment. [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="decoder",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, rope="mrope", input_mode="vl")
