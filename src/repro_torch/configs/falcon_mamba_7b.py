"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16 — mamba-1 architecture. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16,
)


def reduced():
    return reduce_common(CONFIG)
