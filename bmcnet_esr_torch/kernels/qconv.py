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
modes).  The kernel is ``csrc/qconv.cu``; it takes the weights packed by
:func:`pack_weights3x3` (per block of 64 output channels, the sequence of
slabs its loop streams through shared memory, each in the tensor cores'
core-matrix order), which
callers that reuse them pass in ``packed``.  :func:`conv_plan` is the launch
plan (tile, grid, ring stages, shared memory) the wrapper hands to the C
entry point.  Unlike the TPU kernel there is no VMEM gate (``fits_vmem``):
the kernel tiles the image and the channels and takes every shape.

Routing is by the device of the input: CPU tensors go through
:func:`qconv3x3_plain`, CUDA tensors through the kernel (or an exception).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from bmcnet_esr_torch.kernels._build import (
    H100_SMS,
    check_tensor,
    device_kind,
    launch,
    load_library,
)
from bmcnet_esr_torch.kernels.qmm import IN_KINDS, K_STEP, ROW_PAD, SMEM_LIMIT, pad_to
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

# csrc/qconv.cu's constants: the output tile of one lane (rows, columns),
# output channels per block, input channels per ring stage and per staged
# halo block, threads per block (sixteen or eight warps that stage the halo,
# eight of which multiply, and the weight-stream warp), and the shared-memory
# bytes in front of the halo
TILE, BLOCK_N, K_CHUNK, HALO_BLOCK, THREADS = (4, 16), 64, 128, 512, (544, 288)
STAGES = 4  # weight slabs in flight; more did not shorten the loop on an H100
HEAD_BYTES = 128 + 2 * BLOCK_N * 4
STAGE_BYTES = BLOCK_N * K_CHUNK
HALO_PIXELS = (TILE[0] + 2) * (TILE[1] + 2)


def quantize_weights3x3(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``[3, 3, Cin, Cout]`` float32 -> ``(int8 HWIO, scale [Cout])``,
    symmetric per output channel, scale ``max_hwi |w| / 127``."""
    sw = symmetric_scale(w.abs().amax((0, 1, 2)))
    return round_clip_s8(w.float(), sw), sw


def conv_stages(cin: int) -> List[Tuple[int, int, int]]:
    """The kernel's K loop over ``Cin_pad`` as ``(tap, first channel,
    channels)`` per ring stage, in the order it runs: halo blocks of up to
    512 channels, in each the nine taps in (dy, dx) order, in each tap chunks
    of up to 128 channels."""
    cin_pad = pad_to(cin, K_STEP)
    return [
        (tap, hb + c0, min(K_CHUNK, hc - c0))
        for hb in range(0, cin_pad, HALO_BLOCK)
        for hc in [min(HALO_BLOCK, cin_pad - hb)]
        for tap in range(9)
        for c0 in range(0, hc, K_CHUNK)
    ]


def pack_weights3x3(wq: torch.Tensor) -> torch.Tensor:
    """int8 HWIO -> the kernel's ``[Cout_blocks, slab bytes]``: for each block
    of 64 output channels, one slab of ``64 * channels`` bytes per stage of
    :func:`conv_stages`, in the order the tensor cores read it (wgmma's
    K-major layout without swizzle): core matrices of 8 output channels x 16
    input channels, 128 contiguous bytes each, the eight of a 16-channel
    chunk one after another, chunk after chunk.  Zeros past Cin and Cout.
    The kernel's weight stream copies slab after slab, each in one piece."""
    kh, kw, cin, cout = wq.shape
    p = wq.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin)
    p = F.pad(p, (0, pad_to(cin, K_STEP) - cin, 0, 0, 0, pad_to(cout, BLOCK_N) - cout))
    p = p.reshape(-1, BLOCK_N // 8, 8, kh * kw, p.shape[2])  # [block, row group, row, tap, c]
    slabs = [p[:, :, :, tap, c0 : c0 + kc].reshape(-1, BLOCK_N // 8, 8, kc // 16, 16)
             .permute(0, 3, 1, 2, 4).flatten(1) for tap, c0, kc in conv_stages(cin)]
    return torch.cat(slabs, 1).contiguous()


def unpack_weights3x3(packed: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights3x3`: the int8 HWIO it was given."""
    w = packed.new_zeros((packed.shape[0], BLOCK_N, 9, pad_to(cin, K_STEP)))
    at = 0
    for tap, c0, kc in conv_stages(cin):
        slab = packed[:, at : at + BLOCK_N * kc].reshape(-1, kc // 16, BLOCK_N // 8, 8, 16)
        w[:, :, tap, c0 : c0 + kc] = slab.permute(0, 2, 3, 1, 4).reshape(-1, BLOCK_N, kc)
        at += BLOCK_N * kc
    return w.reshape(-1, 3, 3, w.shape[3])[:cout, :, :, :cin].permute(1, 2, 3, 0).contiguous()


def conv_plan(lanes: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS) -> dict:
    """The launch of ``csrc/qconv.cu`` for ``x [lanes, h, w, cin]`` and
    ``cout`` output channels.  A block owns one 4 x 16 pixel tile of one
    lane by 64 output channels: block ``i`` of the grid's first axis is tile
    ``i % (tiles_y * tiles_x)`` (row-major) of lane ``i // (tiles_y *
    tiles_x)``, so no tile spans two lanes.  Shared memory holds the head,
    the int8 halo (6 x 18 pixels by up to 512 channels, rows padded by 16
    bytes) and a ring of four weight slabs of 8 KB.  A grid that gives
    each of the card's ``sms`` multiprocessors at most one block runs blocks
    of 17 warps (sixteen stage the halo); a larger one blocks of 9 warps, two
    to a multiprocessor, so that one's staging overlaps the other's math."""
    th, tw = TILE
    tiles = (-(-h // th), -(-w // tw))
    grid = (lanes * tiles[0] * tiles[1], -(-cout // BLOCK_N))
    cin_pad = pad_to(cin, K_STEP)
    halo_bytes = HALO_PIXELS * (min(cin_pad, HALO_BLOCK) + ROW_PAD)
    return {
        "tile": TILE,
        "block_n": BLOCK_N,
        "threads": THREADS[grid[0] * grid[1] > sms],
        "tiles": tiles,
        "grid": grid,
        "stages": STAGES,
        "cin_pad": cin_pad,
        "smem_bytes": HEAD_BYTES + halo_bytes + STAGES * STAGE_BYTES,
    }


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
    lib.qconv3x3.argtypes = [i, i, *[p] * 7, *[i] * 16, p]
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_plan(lanes, h, w, cin, cout, sms=sms)
    slab = 9 * BLOCK_N * plan["cin_pad"]
    check_tensor(x, "x", x.dtype, (lanes, h, w, cin))
    check_tensor(packed, "packed", torch.int8, (plan["grid"][1], slab))
    check_tensor(sw, "sw", torch.float32, (cout,))
    check_tensor(bias, "bias", torch.float32, (cout,))
    if packed.device != x.device or packed.data_ptr() % 16:
        raise ValueError("packed weights must lie on x's device, 16-byte aligned")
    if lanes * h * w >= 2**31 or h * w * max(cin, cout) >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} does not fit the kernel's int indexing")
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"{plan['smem_bytes']} bytes of shared memory exceed {SMEM_LIMIT}")
    s = lane_scales(sx, lanes, x.device)
    se = None if emit_scale is None else lane_scales(emit_scale, lanes, x.device)
    odt = torch.int8 if se is not None else out_dtype
    out = torch.empty((lanes, h, w, cout), dtype=odt, device=x.device)
    # 16-byte loads need whole vectors per pixel and an aligned base
    vec = cin % (16 if x.dtype == torch.int8 else 8) == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    args = (IN_KINDS[x.dtype], OUT_KINDS[odt], x.data_ptr(), packed.data_ptr(), sw.data_ptr(),
            s.data_ptr(), bias.data_ptr(), None if se is None else se.data_ptr(),
            out.data_ptr(), lanes, h, w, cin, plan["cin_pad"], cout, int(emit_relu), int(vec),
            *plan["tile"], plan["block_n"], plan["threads"], *plan["grid"], plan["stages"],
            plan["smem_bytes"])
    launch(lib.qconv3x3, args, x.device, lib.qconv_error_string)
    launches += 1
    return out
