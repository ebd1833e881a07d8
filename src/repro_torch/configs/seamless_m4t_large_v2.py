"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone.
24 encoder + 24 decoder layers (SeamlessM4T v2 large speech enc / text dec);
audio frontend stubbed as precomputed frame embeddings per assignment.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, input_mode="frames", rope="none")
