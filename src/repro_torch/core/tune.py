"""Hardware calibration for the model-driven autotuner (§5.4 / §6.2).

``measure_hardware(comm)`` micro-benchmarks the paper's four hardware
characteristic parameters for ONE RANK of a communicator, once per
(communicator kind, world size, device, rank count, element size) for the
life of the process:

* ``w_private`` — a STREAM-like copy of 2^22 float32 elements a rank;
* ``cacheline`` — a random gather of 2^20 indices a rank: the model charges
  every non-contiguous local access one ``cacheline`` of traffic, so the
  effective value is ``t_gather * w_private / accesses``, clipped to
  [16, 4096] B;
* ``w_remote`` — ``comm.all_to_all`` of 2^20 float32 a rank, big minus
  tiny;
* ``tau`` — a tiny ``all_to_all`` (a tiny copy when ``p == 1``).

The §5 formulas price each rank and take the max over the ranks that run
concurrently (``perfmodel.t_comp_per_thread``, ``_threads_of_node``).  On
the card all ``p`` ranks of a ``LoopbackComm`` run stacked in one launch
and share one HBM, so every probe runs rank-stacked ``(p, ...)``, as the
strategy rungs do, and each rate is the bytes ONE rank moves over the
stacked probe's time.  A probe of one un-stacked tensor would credit every
rank with the whole card and predict every rung ``p`` times too fast.

Timing: on the card the bandwidth probes are timed with CUDA events, the
device held by a spin kernel while the host enqueues them, so they time
device work; ``tau`` is timed as the reference times it — the median wall
time of one eager call ended by ``torch.cuda.synchronize()``.  With every
rank on one card a message's latency is the host's enqueue and the
synchronization, not a wire.  On the CPU (``LoopbackComm(p,
device="cpu")``) every probe uses the host clock.

On one card the "remote" link is an on-device copy (the loopback
``all_to_all`` is a transpose).  Under a ``DistComm`` each process probes
its own ``p_local`` ranks and ``w_remote`` / ``tau`` come from its
``all_to_all`` over the group (gloo between CPU processes, NCCL on the
card); every probe time is then replaced by its maximum over the ranks
(``all_reduce("max")``: the slowest rank paces every collective), so all
ranks derive the same parameters, and ``strategy="auto"`` the same rung.
Different rungs on different ranks would leave their next collectives
unmatched.  A ``DistComm`` and a ``LoopbackComm`` with the same ``p`` keep
separate calibrations.

The first calibration synchronizes the device, as does a plan's first call
on the card: neither may run inside a CUDA-graph capture.  Calibrate (and
run each engine once) before capturing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.perfmodel import HardwareParams

__all__ = ["measure_hardware", "calibration", "clear_hardware_cache"]

COPY_ELEMS = 1 << 22      # w_private probe, per rank
GATHER_ELEMS = 1 << 20    # cacheline probe, per rank
REMOTE_ELEMS = 1 << 20    # w_remote probe, per rank
TINY_ELEMS = 8            # tau probe, per rank
# cycles a second of torch.cuda._sleep's spin: an H100's top clock (1.98
# GHz) rounded up, so the spin lasts at least the time asked for
_SPIN_CYCLES_PER_S = 2e9

_hw_cache: dict[tuple, tuple[HardwareParams, dict]] = {}


def clear_hardware_cache() -> None:
    _hw_cache.clear()


def _key(comm, elem_bytes: int) -> tuple:
    dev = comm.device
    return (comm.kind, comm.world, dev.type, dev.index, comm.p, elem_bytes)


def _wall(fn, *, iters: int, warmup: int = 3) -> float:
    """Median seconds of one call, the host clock around the call and (on
    the card) the synchronize that ends it."""
    def run():
        out = fn()
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)

    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _device(fn, device, *, iters: int, warmup: int = 3) -> float:
    """Mean device seconds of one call over ``iters`` back-to-back calls,
    timed with CUDA events while a spin kernel holds the device during the
    enqueue (so a call the host enqueues slower than the device runs it is
    still timed on the device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_SPIN_CYCLES_PER_S * (2 * iters * enqueue_s
                                                + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _slowest(comm, times: dict) -> dict:
    """Every probe time replaced by its maximum over ``comm``'s ranks."""
    row = torch.tensor(list(times.values()), dtype=torch.float64,
                       device=comm.device)
    top = comm.all_reduce(row.expand(comm.p_local, -1).contiguous(),
                          "max").wait()[0].tolist()
    return dict(zip(times, top))


def _calibrate(comm, elem_bytes: int) -> tuple[HardwareParams, dict]:
    p, pl, dev = comm.p, comm.p_local, comm.device
    on_card = dev.type == "cuda"

    def timed(fn, iters):
        return (_device(fn, dev, iters=iters) if on_card
                else _wall(fn, iters=iters))

    # -- w_private: STREAM-like copy (read + write), every rank at once --
    n = COPY_ELEMS
    x = torch.arange(pl * n, dtype=torch.float32, device=dev).reshape(pl, n)
    t = {"copy_s": timed(lambda: x * 1.0000001, 10)}

    # -- cacheline: each rank gathers g random elements of its own row --
    g = GATHER_ELEMS
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, n, size=(pl, g)), device=dev)
    t["gather_s"] = timed(lambda: torch.gather(x, 1, idx), 10)

    # -- w_remote and tau: the stacked all_to_all, big minus tiny --
    tiny_per = max(1, TINY_ELEMS // p)
    if p > 1:
        big = torch.zeros((pl, p, REMOTE_ELEMS // p), dtype=torch.float32,
                          device=dev)
        tiny = torch.zeros((pl, p, tiny_per), dtype=torch.float32,
                           device=dev)
        t["all_to_all_big_s"] = timed(lambda: comm.all_to_all(big).wait(), 5)
        t["tau_wall_s"] = _wall(lambda: comm.all_to_all(tiny).wait(),
                                iters=20)
        t["all_to_all_tiny_s"] = timed(
            lambda: comm.all_to_all(tiny).wait(), 20) if on_card \
            else t["tau_wall_s"]
    else:
        tiny = torch.zeros((1, TINY_ELEMS), dtype=torch.float32, device=dev)
        t["tau_wall_s"] = _wall(lambda: tiny * 1.0000001, iters=30)
        t["tiny_copy_s"] = timed(lambda: tiny * 1.0000001, 30) \
            if on_card else t["tau_wall_s"]
    t = _slowest(comm, t)

    w_private = 2.0 * n * 4 / t["copy_s"]
    cacheline = int(np.clip(t["gather_s"] * w_private / g, 16, 4096))
    w_remote = (REMOTE_ELEMS * 4 / max(t["all_to_all_big_s"]
                                       - t["all_to_all_tiny_s"], 1e-9)
                if p > 1 else w_private)
    tau = t["tau_wall_s"]
    raw = {"p": p, "p_local": pl, "comm": comm.kind, "world": comm.world,
           "device": str(dev),
           "timing": "cuda events" if on_card else "host clock", **t,
           "card_copy_bytes_per_s": pl * 2.0 * n * 4 / t["copy_s"],
           "card_gather_per_s": pl * g / t["gather_s"]}

    hw = HardwareParams(w_private=w_private, w_remote=w_remote, tau=tau,
                        cacheline=cacheline, elem=elem_bytes, idx=4)
    return hw, raw


def measure_hardware(comm, *, elem_bytes: int = 4,
                     force: bool = False) -> HardwareParams:
    """The four §5.4 parameters for one rank of ``comm`` (a
    ``LoopbackComm`` or a ``DistComm``), measured on its device, the same
    on every rank.  Memoized per (``comm.kind``, ``comm.world``, device,
    ``comm.p``, ``elem_bytes``) — pass ``force=True`` to re-measure (on
    every rank of a ``DistComm`` at once: the calibration runs
    collectives)."""
    key = _key(comm, elem_bytes)
    if force or key not in _hw_cache:
        _hw_cache[key] = _calibrate(comm, elem_bytes)
    return _hw_cache[key][0]


def calibration(comm, *, elem_bytes: int = 4) -> dict:
    """The memoized calibration's raw probe times (seconds, stacked
    probes), the whole device's copy and gather rates, and ``tau``'s wall
    time — measuring first if ``comm`` was never calibrated."""
    measure_hardware(comm, elem_bytes=elem_bytes)
    return dict(_hw_cache[_key(comm, elem_bytes)][1])
