"""Operations and bytes of the model and of the port's kernels, from shapes.

A frozen copy of the shapes of the full BMCNet (``reference/model.py``,
which follows ``bmcnet_esr_torch/models/bmcnet.py``) and of the arithmetic
of the kernels' bounds: a later change to the program cannot move this
yardstick.  FLOPs count a multiply-add as two, as ``torch.utils.flop_counter``
does; bytes count each input byte read once and each output byte written
once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def conv_calls(n_c: int, n_b: int, scale: int, repeat: int) -> List[Tuple[str, int, int, int, int]]:
    """``(name, cin, cout, kernel, calls)`` of every convolution of one forward."""
    s2, r = scale * scale, repeat
    calls = [("neuro.conv_fpst", 2 * r + n_c + s2, n_c, 3, 2),
             ("neuro.conv_fps", r + n_c, n_c, 3, 2),
             ("neuro.conv_fs", 3 * n_c + 2 * s2, n_c, 3, 3)]
    blk = "neuro.para_reschunk"
    for res in ("conv1", "conv1_st"):  # two sites a block
        calls += [(f"{blk}.{res}.conv1", n_c, n_c, 3, 2 * n_b),
                  (f"{blk}.{res}.conv2", n_c, n_c, 3, 2 * n_b)]
    for bie, sites in (("lBIE", 2), ("gBIE", 1)):  # BIE calls a block
        k = sites * n_b
        p = f"{blk}.{bie}"
        calls += [(f"{p}.conv1.conv1", n_c, n_c, 3, 2 * k), (f"{p}.conv1.conv2", n_c, n_c, 3, 2 * k),
                  (f"{p}.convf1", 2 * n_c, n_c, 1, 2 * k), (f"{p}.clustering", n_c, n_c, 1, 2 * k),
                  (f"{p}.v1", n_c, n_c, 1, k), (f"{p}.v2", n_c, n_c, 1, k),
                  (f"{p}.unclustering", 2 * n_c, n_c, 1, k)]
    calls += [(f"neuro.{n}", n_c, n_c, 3, 1) for n in ("conv_hs", "conv_hp", "conv_hn")]
    calls.append(("neuro.conv_o", 2 * n_c, 2 * s2, 3, 1))
    return calls


def attention_macs_per_pixel(n_c: int, n_b: int) -> int:
    """The BIE attention's two ``bmm`` a call, two calls a BIE, 3 BIEs a block."""
    return 3 * n_b * 2 * 2 * n_c * n_c


def forward_flops(dims: Dict[str, int], hw: Tuple[int, int], batch: int = 1) -> float:
    """FLOPs of one forward of ``batch`` windows at LR ``hw``: convolutions,
    the attention's products and the bilinear skip's two matrix products."""
    h, w = hw
    s = dims["scale"]
    px = h * w
    macs = sum(cin * cout * k * k * calls for _, cin, cout, k, calls in conv_calls(**dims)) * px
    macs += attention_macs_per_pixel(dims["n_c"], dims["n_b"]) * px
    macs += (s * h) * h * w * 2 + (s * h) * (s * w) * w * 2  # rows, then columns
    return 2.0 * macs * batch


def qconv_calls(dims: Dict[str, int], hw: Tuple[int, int], batch: int, in_bytes: int,
                out_bytes: int = 2) -> List[Tuple[float, float]]:
    """``(ops, bytes)`` of each ``quant_conv3x3`` call of one forward (every
    3x3 convolution), input ``in_bytes`` an element (1: int8, 2: bf16)."""
    px = batch * hw[0] * hw[1]
    out = []
    for _, cin, cout, k, calls in conv_calls(**dims):
        if k != 3:
            continue
        ops = 2.0 * px * 9 * cin * cout
        nbytes = px * cin * in_bytes + 9 * cin * cout + 8 * cout + 4 * batch + px * cout * out_bytes
        out += [(ops, float(nbytes))] * calls
    return out


def qmm_calls(dims: Dict[str, int], hw: Tuple[int, int], batch: int, in_bytes: int,
              out_bytes: int = 2) -> List[Tuple[float, float]]:
    """``(ops, bytes)`` of each ``quant_matmul`` call of one forward (every
    1x1 convolution)."""
    px = batch * hw[0] * hw[1]
    out = []
    for _, cin, cout, k, calls in conv_calls(**dims):
        if k != 1:
            continue
        ops = 2.0 * px * cin * cout
        nbytes = px * cin * in_bytes + cin * cout + 8 * cout + 4 * batch + px * cout * out_bytes
        out += [(ops, float(nbytes))] * calls
    return out


def raster_call(windows: int, n_events: int, hw: Tuple[int, int]) -> Tuple[float, float]:
    """``(ops, bytes)`` of one compact rasterizer call: int16 x and y and an
    int8 polarity an event read, a float32 count image of two channels a
    window written; an add an event."""
    return float(windows * n_events), float(windows * (n_events * 5 + hw[0] * hw[1] * 2 * 4))


def bound_s(calls, ops_per_s: float, bytes_per_s: float) -> float:
    """The least time of ``calls`` ``[(ops, bytes), ...]`` on the card: each
    call bound by its operations or its bytes, whichever takes longer."""
    return sum(max(ops / ops_per_s, nbytes / bytes_per_s) for ops, nbytes in calls)
