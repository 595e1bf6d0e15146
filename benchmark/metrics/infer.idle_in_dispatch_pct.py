"""Share of the rollout in which the host is enqueueing a chunk
(``rollout.dispatch``) and no device record runs: the device waiting on the
host's launches (``program_span`` against the device trace)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.dispatch"):
        return None
    return 100.0 * k.idle_ms("rollout.dispatch") / k.ms("rollout")
