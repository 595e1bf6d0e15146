"""Share of the rollout's window pairs that a CUDA graph's replay served
(``rollout.replay`` windows over ``rollout`` windows, ``program_span``).  A
program without the graphs keeps no ``rollout.replay`` span: nothing read."""

from benchmark import spans


def read(run):
    k = spans.kept(run, "rollout")
    if k is None or not k.has("rollout.replay"):
        return None
    return 100.0 * k.attr("rollout.replay", "windows") / k.attr("rollout", "windows")
