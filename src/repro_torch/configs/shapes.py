"""The four assigned input shapes and per-arch applicability rules: a copy
of ``repro.configs.shapes``."""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "applicable", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    mode: str         # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg, shape: ShapeSpec) -> str | None:
    """None = run the cell; else the reason the cell is skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention: 500k decode requires "
                "sub-quadratic context (SSM/SWA) — skipped per assignment")
    return None


def applicable(cfg, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None
