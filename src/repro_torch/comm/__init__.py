"""Irregular-communication layer: patterns, plans, the strategy ladder and
the gather front door."""
