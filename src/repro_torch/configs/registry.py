"""Architecture registry: the 10 assigned configs + the paper's SpMV problems.

``get_config(name)`` returns the exact published configuration;
``get_config(name, reduced=True)`` returns the same-family smoke-test variant
(small widths/layers/experts/vocab) used by tests on CPU.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ARCH_NAMES", "get_config"]

ARCH_NAMES = (
    "mixtral-8x22b",
    "arctic-480b",
    "granite-20b",
    "minitron-4b",
    "qwen2.5-32b",
    "llama3-8b",
    "hymba-1.5b",
    "falcon-mamba-7b",
    "whisper-tiny",
    "llama-3.2-vision-90b",
)

_MODULES = {name: name.replace("-", "_").replace(".", "_")
            for name in ARCH_NAMES}


def get_config(name: str, *, reduced: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.CONFIG
    if reduced:
        cfg = mod.reduced()
    return cfg


def reduce_common(cfg, **over):
    """Default reduction: tiny widths, few layers, small vocab; preserves
    family, attention flavor, MoE/SSM structure."""
    num_heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    num_kv = min(cfg.num_kv_heads, num_heads) if num_heads else 0
    if num_heads and cfg.num_kv_heads == 1:
        num_kv = 1  # preserve MQA
    upd = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=16 if num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        residual_d_ff=64 if cfg.dense_residual else 0,
        swa_window=16 if cfg.swa_window else 0,
        ssm_state=min(cfg.ssm_state, 8),
        ssm_dt_rank=8 if cfg.ssm_state else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=32 if cfg.encoder_seq else 0,
        cross_attn_period=min(cfg.cross_attn_period, 2),
        num_image_tokens=16 if cfg.num_image_tokens else 0,
    )
    upd.update(over)
    return dataclasses.replace(cfg, **upd)
