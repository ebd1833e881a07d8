"""rwkv6-1.6b [ssm] (Finch): attention-free, data-dependent decay.
Sub-quadratic -> long_500k runs. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, rope="none", block_pattern=("rwkv",), rwkv_head_dim=64)
