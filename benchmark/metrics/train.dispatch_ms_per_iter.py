"""Host time enqueueing the training step (``train.step``: forward, backward
and Adam) an iteration (``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "train.iteration")
    if k is None or not k.has("train.step"):
        return None
    return k.ms("train.step") / k.count("train.iteration")
