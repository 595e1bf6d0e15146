"""Shared arithmetic of the per-layer metric readers (``benchmark/metrics/*.py``).

A reader is ``read(run) -> float | None``; ``run`` is the mode's record of a
``--trace 1`` run.  A reader that finds nothing to read returns ``None`` and
the harness leaves its metric out of the line."""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

from benchmark import devtrace, flops

PEAK_KEY = {"int8": "int8_ops_per_s", "bf16": "bf16_flops_per_s", "fp32": "fp32_flops_per_s"}


def peaks() -> Dict:
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "peaks.json")) as f:
        return json.load(f)


def idle_pct(run: Dict) -> Optional[float]:
    dev = run.get("device", {})
    if not dev.get("window_s") or "busy_s" not in dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])


def roofline_pct(run: Dict, pattern: str) -> Optional[float]:
    """The least time of the calls the traced span made of a kernel (its
    operations at the int8 peak or its bytes at HBM bandwidth, whichever
    bounds each call) over the kernel's summed device time."""
    tr = run.get("trace") or {}
    calls = tr.get("calls", {}).get(pattern)
    if not calls:
        return None
    seconds, count = devtrace.kernel_time_s(tr["records"], pattern)
    if count != len(calls) or seconds <= 0:
        print(f"{pattern}: the trace holds {count} records of the {len(calls)} calls made; "
              "no roofline read", file=sys.stderr)
        return None
    pk = peaks()
    return 100.0 * flops.bound_s(calls, pk["int8_ops_per_s"], pk["hbm_bytes_per_s"]) / seconds


def mfu_pct(run: Dict) -> Optional[float]:
    """Model FLOPs a window (or iteration) times the rate of the untraced
    measured window, as a share of the peak of the cell's product precision."""
    w = run.get("window") or {}
    if not w.get("seconds") or not w.get("windows"):
        return None
    rate = run["flops_per_window"] * w["windows"] / w["seconds"]
    return 100.0 * rate / peaks()[PEAK_KEY[run["precision"]]]
