"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    swa_window=4096, rope_theta=1e6,
)


def reduced():
    return reduce_common(CONFIG)
