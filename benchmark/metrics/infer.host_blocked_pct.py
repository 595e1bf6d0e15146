"""Share of the rollout in which the host waits on the device for a chunk's
results (``rollout.drain`` over ``rollout``, ``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.drain"):
        return None
    return 100.0 * k.ms("rollout.drain") / k.ms("rollout")
