"""The spans of a traced training window placed in their ``train.iteration``
by time, for the readers of the loss terms and of remat's recompute.

Remat reruns a step's body inside the backward, on autograd's device thread
on a GPU: a span opened there has no parent on its thread, so
``benchmark/spans.py::kept`` cannot reach its iteration through its
ancestors.  The backward runs while the main thread waits in it, inside the
iteration's ``train.step``, so a span belongs to the kept iteration whose
interval holds it.  The iterations kept are ``spans.kept``'s: those wholly
inside the traced window."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import spans

Interval = Tuple[float, float]  # microseconds


class Placed:
    """The kept iterations and the spans that lie inside one of them."""

    def __init__(self, iterations: List[Interval], by_name: Dict[str, List[Tuple[float, float, dict]]]):
        self.iterations, self.by_name = iterations, by_name

    def named(self, prefix: str) -> List[Tuple[float, float, dict]]:
        """The spans whose name is ``prefix`` or starts with ``prefix.``."""
        return [s for n, v in self.by_name.items() if n == prefix or n.startswith(prefix + ".")
                for s in v]

    def ms_per_iteration(self, prefix: str) -> Optional[float]:
        found = self.named(prefix)
        if not found:
            return None
        return sum(e - s for s, e, _ in found) * 1e-3 / len(self.iterations)


def placed(run: Dict) -> Optional[Placed]:
    k = spans.kept(run, "train.iteration")
    if k is None:
        return None
    iterations = [(s, e) for s, e, _ in k.by_name["train.iteration"]]
    trace = run["trace"]
    lo, hi = spans.window(trace["records"], trace.get("window_s"))
    by_name: Dict[str, List[Tuple[float, float, dict]]] = {}
    for sp in spans.program_spans():
        s, e = sp.start_ns * 1e-3, sp.end_ns * 1e-3
        if lo <= s and e <= hi and any(a <= s and e <= b for a, b in iterations):
            by_name.setdefault(sp.name, []).append((s, e, sp.attrs))
    return Placed(iterations, by_name)
