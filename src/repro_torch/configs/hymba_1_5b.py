"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, swa_window=1024,
)


def reduced():
    return reduce_common(CONFIG, num_heads=4, num_kv_heads=2)
