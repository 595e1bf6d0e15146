"""``csrc/qmm.cu`` (``qmm_kernel``): share of its roofline over the traced span."""

from benchmark.metrics._lib import roofline_pct


def read(run):
    return roofline_pct(run, "qmm_kernel")
