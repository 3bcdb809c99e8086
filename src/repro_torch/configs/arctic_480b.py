"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    num_experts=128, experts_per_token=2,
    dense_residual=True, residual_d_ff=4864,
)


def reduced():
    return reduce_common(CONFIG)
