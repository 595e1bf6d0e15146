"""Host time inside the loss terms' calls (``train.loss.<term>``), the first
pass and remat's recompute, an iteration (``program_span``)."""

from benchmark.metrics._by_time import placed


def read(run):
    p = placed(run)
    return None if p is None else p.ms_per_iteration("train.loss")
