"""Activation quantize: the hand-written CUDA kernel, its plain version, and
the int8 arithmetic that the plain versions of all three int8 kernels share.

Counterpart of ``bmcnet_esr_tpu/ops/pallas/quantize.py`` (``quantize_act``,
kernel body ``_quant_kernel``; ``quantize_reference``): ``x [B, H, W, C]``
bf16 / float32 -> int8 at a static per-lane scale ``sx`` (scalar, ``[1]`` or
``[B]``), ``clip(round_half_even([relu](x) / sx[b]), -127, 127)``.  The
kernel is ``csrc/quantize.cu``; :func:`quantize_plan` sizes its grid.

Routing is by the device of the input: a CPU tensor goes through
:func:`quantize_plain`, a CUDA tensor through the kernel (or an exception;
there is no fallback).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bmcnet_esr_torch.kernels._build import H100_SMS, device_kind, launch, load_library

SOURCE = "quantize.cu"

# kernel launches in this process (plain-version calls are not counted)
launches = 0

# csrc/quantize.cu's constants: threads per block, elements a thread
# quantizes per step (one 4-byte store), and the blocks of one
# multiprocessor that the plan counts on being resident together
THREADS, UNIT, BLOCKS_PER_SM = 256, 4, 8


def quantize_plan(lanes: int, per_lane: int, sms: int = H100_SMS) -> dict:
    """The launch of ``csrc/quantize.cu`` for ``lanes`` lanes of ``per_lane``
    elements: a grid of ``(blocks, lanes)`` blocks of 256 threads.  Thread
    ``t`` of a lane's ``blocks * 256`` takes the units of 4 elements ``t``,
    ``t + blocks * 256``, ...: one unit each while the card has room for all
    blocks at once (``sms * 8`` of them), a loop inside the block beyond."""
    units = -(-per_lane // UNIT)
    room = max(1, sms * BLOCKS_PER_SM // max(lanes, 1))
    blocks = max(1, min(-(-units // THREADS), room))
    return {"threads": THREADS, "unit": UNIT, "grid": (blocks, lanes)}


def symmetric_scale(amax: torch.Tensor) -> torch.Tensor:
    """int8 scale ``max(amax, 1e-12) / 127`` in float32, divided exactly:
    on CUDA, PyTorch computes ``t / 127.0`` (a host scalar) as
    ``t * (1 / 127)``, which rounds once more than the JAX package does."""
    a = torch.clamp(amax.float(), min=1e-12)
    return a / a.new_full((), 127.0)


def lane_scales(sx, lanes: int, device) -> torch.Tensor:
    """A scale given as a scalar, ``[1]`` or ``[lanes]`` -> float32
    ``[lanes]`` on ``device`` (a single scale serves every lane)."""
    s = torch.as_tensor(sx, dtype=torch.float32, device=device).reshape(-1)
    if s.numel() == 1:
        return s.expand(lanes).contiguous()
    if s.numel() != lanes:
        raise ValueError(f"{s.numel()} scales for {lanes} lanes: give 1 or {lanes}")
    return s.contiguous()


def _per_lane(s: torch.Tensor, ndim: int) -> torch.Tensor:
    return s.view(-1, *([1] * (ndim - 1)))


def round_clip_s8(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(v / s), -127, 127)`` as int8 (``s`` broadcasts)."""
    return torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)


def quantize_plain(x: torch.Tensor, sx, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_act` (any leading lane axis)."""
    xf = x.float()
    if relu:
        xf = torch.clamp_min(xf, 0.0)
    return round_clip_s8(xf, _per_lane(lane_scales(sx, x.shape[0], x.device), x.dim()))


def epilogue_plain(
    acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
    out_dtype: torch.dtype, emit_scale=None, emit_relu: bool = False,
) -> torch.Tensor:
    """The int8 kernels' epilogue on an int32 accumulator ``[B, ..., N]``:
    ``acc * (sx[b] * sw[n]) + bias[n]`` in float32 (product first, no fused
    multiply-add), then either a cast to ``out_dtype`` or, with
    ``emit_scale``, an optional ReLU and int8 at ``emit_scale[b]``."""
    y = acc.float() * (_per_lane(sx, acc.dim()) * sw) + bias
    if emit_scale is None:
        return y.to(out_dtype)
    if emit_relu:
        y = torch.clamp_min(y, 0.0)
    return round_clip_s8(y, _per_lane(lane_scales(emit_scale, acc.shape[0], acc.device), acc.dim()))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("quantize_act_bf16", "quantize_act_f32"):
        getattr(lib, name).argtypes = [p, p, p, i, i, i, i, p]
        getattr(lib, name).restype = i
    lib.quantize_empty.argtypes = [i, i, p]
    lib.quantize_empty.restype = i
    lib.quantize_error_string.argtypes = [i]
    lib.quantize_error_string.restype = ctypes.c_char_p
    return lib


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def quantize_act(x: torch.Tensor, sx, relu: bool = False) -> torch.Tensor:
    """``x [B, H, W, C]`` (NHWC-contiguous bf16 or float32) -> int8, per-lane
    scales ``sx`` (scalar, ``[1]`` or ``[B]``), optional fused ReLU."""
    global launches
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected 4-D bf16 or float32, got {x.dim()}-D {x.dtype}")
    if device_kind(x) == "cpu":
        return quantize_plain(x, sx, relu)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    lanes = x.shape[0]
    per_lane = x[0].numel() if lanes else 0
    if per_lane >= 2**31:
        raise ValueError(f"{per_lane} elements per lane do not fit the kernel's int indexing")
    s = lane_scales(sx, lanes, x.device)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = lib.quantize_act_bf16 if x.dtype == torch.bfloat16 else lib.quantize_act_f32
    blocks = quantize_plan(lanes, per_lane, sms=_sms(x.device))["grid"][0]
    launch(fn, (x.data_ptr(), s.data_ptr(), out.data_ptr(), lanes, per_lane, int(relu), blocks),
           x.device, lib.quantize_error_string)
    launches += 1
    return out


def launch_empty_grid(x: torch.Tensor) -> None:
    """Launch a kernel that does nothing on the grid :func:`quantize_act`
    takes for ``x``: the floor of one launch of that size, for measurement."""
    lanes = x.shape[0]
    blocks = quantize_plan(lanes, x[0].numel(), sms=_sms(x.device))["grid"][0]
    lib = _lib()
    launch(lib.quantize_empty, (lanes, blocks), x.device, lib.quantize_error_string)
