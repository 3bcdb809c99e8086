"""PyTorch + CUDA port of ``repro``: the distributed modified-EllPack SpMV
and the irregular-gather strategy ladder that carries it, and the LM
serving stack, on NVIDIA Hopper.

The port mirrors ``repro``'s layout — ``comm/`` (plan, strategies, gather),
``core/`` (matrix, SpMV engine, Heat2D, solvers), ``kernels/`` (CUDA
kernels and their plain versions), ``configs/``, ``models/``,
``runtime/``, ``serve/`` and ``launch/`` (the serving path) — and imports
neither JAX nor ``repro``.  Per-rank state carries a
leading rank axis ``(P, ...)``; ``comm.communicator.LoopbackComm`` runs the
collectives of ``P`` virtual ranks on one device.  Entry points take
``device=None``, which means ``"cuda"``, and raise without a card unless the
caller asks for ``device="cpu"``.
"""
