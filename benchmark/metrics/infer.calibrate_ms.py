"""Host time calibrating the int8 static scales (``rollout.calibrate``) a
rollout (``program_span``)."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.calibrate"):
        return None
    return k.ms("rollout.calibrate") / k.count("rollout")
