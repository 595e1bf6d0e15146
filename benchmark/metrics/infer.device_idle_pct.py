"""Share of the traced span in which no device record ran (``device_trace``)."""

from benchmark.metrics._lib import idle_pct


def read(run):
    return idle_pct(run)
