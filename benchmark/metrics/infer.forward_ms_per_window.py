"""Host time in the model's calls (``rollout.forward``, inside
``rollout.dispatch``) a window pair (``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.forward"):
        return None
    return k.ms("rollout.forward") / k.attr("rollout", "windows")
