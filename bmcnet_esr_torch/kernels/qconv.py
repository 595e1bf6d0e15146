"""W8A8 3x3 SAME convolution: the hand-written CUDA kernel and its plain
version.

Counterpart of ``bmcnet_esr_tpu/ops/pallas/qconv.py`` (``quantize_weights3x3``,
``quant_conv3x3`` with kernel body ``_qconv_kernel``, ``qconv3x3_reference``)
and of the int8 ``lax.conv`` in ``QuantConv._convolve``
(``bmcnet_esr_tpu/models/layers.py:343-365``):

    acc = conv3x3_SAME(q(x), wq)                 (int32, zero border taps)
    y   = acc * (sx[b] * sw[n]) + bias[n]        (float32)

Input forms: ``x`` bf16 / float32, quantized at the per-lane scale ``sx``
inside the kernel (the fused Pallas route), or ``x`` int8 already quantized
at ``sx``.  Output forms: ``out_dtype`` (bf16 / float32), or with
``emit_scale`` an optional ReLU and int8 at that per-lane scale (the chain
modes).  The kernel is ``csrc/qconv.cu``; it takes the weights packed as
``[Cout, 9, Cin_pad]`` (:func:`pack_weights3x3`), which callers that reuse
them pass in ``packed``.  Unlike the TPU kernel there is no VMEM gate
(``fits_vmem``): the kernel tiles the image and takes every shape.

Routing is by the device of the input: CPU tensors go through
:func:`qconv3x3_plain`, CUDA tensors through the kernel (or an exception).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bmcnet_esr_torch.kernels._build import check_tensor, device_kind, launch, load_library
from bmcnet_esr_torch.kernels.qmm import IN_KINDS, K_STEP
from bmcnet_esr_torch.kernels.quantize import (
    epilogue_plain,
    lane_scales,
    quantize_plain,
    round_clip_s8,
    symmetric_scale,
)

SOURCE = "qconv.cu"

# kernel launches in this process (plain-version calls are not counted)
launches = 0

OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def quantize_weights3x3(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``[3, 3, Cin, Cout]`` float32 -> ``(int8 HWIO, scale [Cout])``,
    symmetric per output channel, scale ``max_hwi |w| / 127``."""
    sw = symmetric_scale(w.abs().amax((0, 1, 2)))
    return round_clip_s8(w.float(), sw), sw


def pack_weights3x3(wq: torch.Tensor) -> torch.Tensor:
    """int8 HWIO -> the kernel's ``[Cout, 9, Cin_pad]`` (taps in (dy, dx)
    order, channels contiguous, zeros past Cin, ``Cin_pad`` a multiple of 32)."""
    kh, kw, cin, cout = wq.shape
    p = wq.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin)
    return F.pad(p, (0, -cin % K_STEP)).contiguous()


def conv3x3_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 SAME convolution of int8 NHWC ``xq`` with int8 HWIO ``wq``,
    computed in float64 (every partial sum is an integer below 2**53, so
    the result is exact; float32 is not: |acc| reaches 9*416*127**2 > 2**24)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(3, 2, 0, 1).double(), padding=1)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def qconv3x3_plain(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, sx, bias: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16, emit_scale=None, emit_relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_conv3x3` (NHWC in and out)."""
    s = lane_scales(sx, x.shape[0], x.device)
    xq = x if x.dtype == torch.int8 else quantize_plain(x, s)
    acc = conv3x3_acc_plain(xq, wq)
    return epilogue_plain(acc, s, sw, bias, out_dtype, emit_scale, emit_relu)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qconv3x3.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.qconv3x3.restype = i
    lib.qconv_error_string.argtypes = [i]
    lib.qconv_error_string.restype = ctypes.c_char_p
    return lib


def quant_conv3x3(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, sx, bias: torch.Tensor,
    *, out_dtype: torch.dtype = torch.bfloat16, emit_scale=None, emit_relu: bool = False,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``y [B, H, W, Cout]`` from NHWC ``x [B, H, W, Cin]`` (int8 at ``sx``,
    or bf16 / float32 quantized at ``sx``), int8 HWIO ``wq`` with scales
    ``sw [Cout]`` and ``bias [Cout]``; per-lane scales are a scalar, ``[1]``
    or ``[B]``.  With ``emit_scale`` the result is int8 at that scale,
    after a ReLU when ``emit_relu``."""
    global launches
    if x.dim() != 4 or x.dtype not in IN_KINDS:
        raise TypeError(f"x: expected NHWC int8, bf16 or float32, got {x.dim()}-D {x.dtype}")
    if wq.dim() != 4 or tuple(wq.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    if emit_scale is None and out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    lanes, h, w, cin = x.shape
    cout = wq.shape[3]
    if device_kind(x, wq, sw, bias) == "cpu":
        return qconv3x3_plain(x, wq, sw, sx, bias, out_dtype, emit_scale, emit_relu)
    if packed is None:
        packed = pack_weights3x3(wq)
    cin_pad = cin + (-cin % K_STEP)
    check_tensor(x, "x", x.dtype, (lanes, h, w, cin))
    check_tensor(packed, "packed", torch.int8, (cout, 9, cin_pad))
    check_tensor(sw, "sw", torch.float32, (cout,))
    check_tensor(bias, "bias", torch.float32, (cout,))
    if packed.device != x.device or packed.data_ptr() % 16:
        raise ValueError("packed weights must lie on x's device, 16-byte aligned")
    if lanes * h * w >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} does not fit the kernel's int indexing")
    s = lane_scales(sx, lanes, x.device)
    se = None if emit_scale is None else lane_scales(emit_scale, lanes, x.device)
    odt = torch.int8 if se is not None else out_dtype
    out = torch.empty((lanes, h, w, cout), dtype=odt, device=x.device)
    lib = _lib()
    args = (IN_KINDS[x.dtype], OUT_KINDS[odt], x.data_ptr(), packed.data_ptr(), sw.data_ptr(),
            s.data_ptr(), bias.data_ptr(), None if se is None else se.data_ptr(),
            out.data_ptr(), lanes, h, w, cin, cin_pad, cout, int(emit_relu))
    launch(lib.qconv3x3, args, x.device, lib.qconv_error_string)
    launches += 1
    return out
