"""Plain PyTorch references of what the benchmark checks.

Nothing here imports ``bmcnet_esr_torch``, ``bmcnet_esr_tpu`` or JAX, and
nothing takes a weight, scale or table that the program made: the benchmark
hands both sides the same seeded weights and events, and these modules work
everything else out again.
"""
