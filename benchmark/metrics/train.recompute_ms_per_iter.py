"""Host time inside the step bodies that remat reruns in the backward
(``train.recompute``) an iteration (``program_span``)."""

from benchmark.metrics._by_time import placed


def read(run):
    p = placed(run)
    return None if p is None else p.ms_per_iteration("train.recompute")
