"""arctic-480b [moe]: 128 experts top-2 PLUS a dense residual MLP in
parallel (Snowflake Arctic dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="decoder",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_pad=16,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True))
