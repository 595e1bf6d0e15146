"""The whole step's model FLOPs times the untraced window's rate, against the
published dense peak of the cell's product precision (``benchmark/peaks.json``)."""

from benchmark.metrics._lib import mfu_pct


def read(run):
    return mfu_pct(run)
