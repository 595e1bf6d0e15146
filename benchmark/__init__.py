"""The benchmark of ``bmcnet_esr_torch`` on NVIDIA GPUs: ``python3 benchmark/run.py``."""
