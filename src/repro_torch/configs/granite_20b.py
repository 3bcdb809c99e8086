"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
)


def reduced():
    return reduce_common(CONFIG)
