"""whisper-tiny [audio enc-dec]: 4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865 — conv frontend is a STUB (input_specs provides precomputed
frame embeddings, 1500 frames). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    encoder_layers=4, encoder_seq=1500,
    act="gelu", norm="layernorm",
)


def reduced():
    return reduce_common(CONFIG)
