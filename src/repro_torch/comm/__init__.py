"""Irregular-communication layer: patterns, plans, the strategy ladder and
its two front doors, the gather (pull) and the scatter (push)."""
