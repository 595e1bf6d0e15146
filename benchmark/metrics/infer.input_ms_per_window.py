"""Host time waiting on the loader thread (``rollout.load_wait``) and
enqueueing the uploads (``rollout.upload``) a window pair
(``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.load_wait", "rollout.upload"):
        return None
    return k.ms("rollout.load_wait", "rollout.upload") / k.attr("rollout", "windows")
