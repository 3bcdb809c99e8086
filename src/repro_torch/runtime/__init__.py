"""Train and serve step builders (``steps``) and the fault-tolerance
utilities of the training entry point (``fault``)."""
