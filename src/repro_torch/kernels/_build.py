"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` source is compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source and all started together, then linked into
one shared library with a plain C interface that ``ctypes`` loads.  The
library lands in ``build/repro_torch_kernels/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing is built when the module is
imported: the first kernel launch builds, or a caller does so ahead of time
with ``load()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

__all__ = ["load", "build_library", "build_info", "launch", "LAUNCHES",
           "ENTRIES"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
# name -> argtypes; every pointer and the stream are c_void_p
_SIGNATURES = {
    "rt_pack_gather": (_P, _P, _P, _I, _I, _I, _I, _P),
    "rt_unpack_scatter_set": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.c_int, _P),
    "rt_unpack_dest": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.c_int, _P),
    "rt_unpack_dest_sorted": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.c_int, _P),
    "rt_unpack_dest_spmv_sorted": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, ctypes.c_int, _P),
    "rt_unpack_scatter_tiles": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, ctypes.c_int, _P),
    "rt_ellpack_spmv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        ctypes.c_int, ctypes.c_int, _P),
    "rt_ellpack_spmv_sorted": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, ctypes.c_int, ctypes.c_int, _P),
    "rt_accumulate_segments": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, ctypes.c_int, ctypes.c_int, _P),
    "rt_accumulate_into": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, ctypes.c_int, ctypes.c_int, _P),
    "rt_fold_long_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, ctypes.c_int, ctypes.c_int, _P, _P),
    "rt_fold_gate": (_P, _I, _P),
    "rt_stencil2d_f32": (_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "rt_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, ctypes.c_int, ctypes.c_int,
                            ctypes.c_float, _P),
    "rt_decode_attention_partial": (_P,) * 10 + (_I,) * 6 + (
        ctypes.c_int, ctypes.c_int, ctypes.c_float, _P),
    "rt_selective_scan_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rt_selective_scan_ckpt_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _P),
    "rt_selective_scan_bwd_f32": (_P,) * 15 + (_I,) * 4 + (_P,),
    "rt_selective_scan_bwd_occupancy": (_I,) * 3 + (_P,),
    "rt_selective_scan_bf16": (_P,) * 7 + (_I,) * 6 + (_P,),
    "rt_selective_scan_bf16_bwd": (_P,) * 16 + (_I,) * 5 + (_P,),
}

_lib = None
_info: dict = {}

# kernel name -> launches so far; each wrapper adds one where it launches
LAUNCHES = {"pack_gather": 0, "unpack_scatter_set": 0, "unpack_dest": 0,
            "ellpack_spmv_windowed": 0, "accumulate_segments": 0,
            "accumulate_into": 0, "stencil2d": 0, "decode_attention": 0,
            "decode_attention_partial": 0, "selective_scan": 0, "selective_scan_bwd": 0,
            "selective_scan_bf16": 0, "selective_scan_bf16_bwd": 0}
# C entry point -> launches so far: which variant of a kernel ran
ENTRIES: dict[str, int] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    assert srcs, f"no CUDA sources under {CSRC}"
    return srcs


def _digest(srcs) -> str:
    """The sources', their directories' headers' and the flags' hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({c for s in srcs for c in s.parent.glob("*.cuh")})
    for s in [*srcs, *headers]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs, lib_path: pathlib.Path) -> dict:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            obj = pathlib.Path(tmp) / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for s, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {s.name}\n{out}")
            if proc.returncode != 0:
                for _, _, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
            objs.append(str(obj))
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: a reader never sees half
    return {"seconds": time.perf_counter() - t0, "log": "\n".join(logs),
            "built": True}


def build_library(srcs, stem: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``srcs`` (``*.cu`` paths) into ``BUILD_DIR/lib<stem>-<hash>.so``
    unless that file exists, and load it: ``(library, info)`` as
    ``build_info`` describes.  The port's kernels go through ``load``; tools
    build their own probes with this."""
    srcs = sorted(pathlib.Path(s) for s in srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{stem}-{_digest(srcs)}.so"
    info = ({"seconds": 0.0, "log": "", "built": False} if lib_path.exists()
            else _compile(srcs, lib_path))
    info["path"] = str(lib_path)
    return ctypes.CDLL(str(lib_path)), info


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = build_library(_sources(), "repro_torch_kernels")
    _info.update(info)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_info() -> dict:
    """How the loaded library came to be: ``seconds`` spent in nvcc,
    ``built`` (False when an earlier build was reused), its ``path`` and
    nvcc's ``log`` (ptxas register and spill counts)."""
    return dict(_info)


def launch(kernel: str | None, entry: str, device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream (appended
    as the last argument), raise on a CUDA error, count one launch of
    ``kernel`` (None: a further launch of a kernel already counted) and
    one of ``entry``."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{entry} failed: cudaError_t {status}")
    if kernel is not None:
        LAUNCHES[kernel] += 1
    ENTRIES[entry] = ENTRIES.get(entry, 0) + 1
