"""Host time enqueueing the rollout's chunks (``rollout.dispatch``: the model
calls and the per-window bicubic and MSE glue) a window pair
(``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.dispatch"):
        return None
    return k.ms("rollout.dispatch") / k.attr("rollout.dispatch", "windows")
