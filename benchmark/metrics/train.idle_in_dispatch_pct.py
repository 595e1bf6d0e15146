"""Share of the iterations in which the host is enqueueing the step
(``train.step``) and no device record runs: the device waiting on the host's
launches (``program_span`` against the device trace)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "train.iteration")
    if k is None or not k.has("train.step"):
        return None
    return 100.0 * k.idle_ms("train.step") / k.ms("train.iteration")
