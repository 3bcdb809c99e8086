"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attention image layers every 5th layer; vision frontend
is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import reduce_common

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    cross_attn_period=5, num_image_tokens=1601,
    rope_theta=5e5,
)


def reduced():
    return reduce_common(CONFIG)
