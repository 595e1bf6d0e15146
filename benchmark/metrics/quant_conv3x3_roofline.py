"""``csrc/qconv.cu`` (``qconv3x3_kernel``): share of its roofline over the traced span."""

from benchmark.metrics._lib import roofline_pct


def read(run):
    return roofline_pct(run, "qconv3x3_kernel")
