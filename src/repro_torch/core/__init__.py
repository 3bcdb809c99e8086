"""Workloads on the comm layer: the EllPack matrix and the distributed SpMV
engine."""
