"""Host time taking the next batch from the loader and enqueueing its upload
(``train.input``) an iteration (``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "train.iteration")
    if k is None or not k.has("train.input"):
        return None
    return k.ms("train.input") / k.count("train.iteration")
