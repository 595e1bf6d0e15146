"""``csrc/rasterize.cu`` (``band_kernel``): share of its roofline over the
traced span; bytes-bound (compact events read, count images written)."""

from benchmark.metrics._lib import roofline_pct


def read(run):
    return roofline_pct(run, "band_kernel")
