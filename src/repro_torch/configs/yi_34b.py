"""yi-34b [dense]: llama-arch GQA. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

# head_pad=16: 56 q-heads pad to 64 for TP-16 alignment (zero-masked pad
# heads at the tail of each kv group, numerically exact).
CONFIG = ModelConfig(
    name="yi-34b", family="decoder",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_pad=16)
