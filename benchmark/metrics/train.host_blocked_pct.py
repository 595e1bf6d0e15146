"""Share of the iterations in which the host waits on the device
(``train.wait`` over ``train.iteration``, ``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "train.iteration")
    if k is None or not k.has("train.wait"):
        return None
    return 100.0 * k.ms("train.wait") / k.ms("train.iteration")
