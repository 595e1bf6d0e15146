"""W8A8 matrix product (the 1x1 convolution): the hand-written CUDA kernel
and its plain version.

Counterpart of ``bmcnet_esr_tpu/ops/pallas/qmm.py`` (``quantize_weights``,
``quant_matmul`` with kernel body ``_qmm_kernel``, ``qmm_reference``):

    y[b, m, n] = (sum_k q(x)[b, m, k] * wq[k, n]) * (sx[b] * sw[n]) + bias[n]

with int32 accumulation and a float32 epilogue.  ``x`` is bf16 / float32 and
quantized at the per-lane scale ``sx`` inside the kernel (the fused Pallas
route), or int8 already quantized at ``sx`` (the dynamic-scale route of
``QuantConv``).  The kernel is ``csrc/qmm.cu``; it takes the weights packed
by :func:`pack_weights` (per block of 128 output channels, the ``[128, K + 16]``
slab the kernel copies into shared memory in one piece), which callers that
reuse them pass in ``packed``.  :func:`matmul_plan` is the launch plan the
wrapper hands to the C entry point.

The kernel is the operator ``bmcnet::quant_matmul`` (per-lane float32
scales, ``out_dtype`` a ``torch.dtype``, ``packed`` optional): the
dispatcher routes by the device of the inputs, CPU tensors through
:func:`qmm_plain`, CUDA tensors through the kernel (or an exception), fake
tensors to the output's shape.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from bmcnet_esr_torch.kernels._build import (
    SMEM_LIMIT,
    check_tensor,
    define_op,
    dense,
    device_kind,
    launch,
    load_library,
    refuse_strided,
)
from bmcnet_esr_torch.kernels.quantize import (
    epilogue_plain,
    lane_scales,
    quantize_plain,
    round_clip_s8,
    symmetric_scale,
)

SOURCE = "qmm.cu"
K_STEP = 32  # one tensor-core K step: packed weights are zero-padded to a multiple
# csrc/qmm.cu's constants: rows and output channels per block, the longest K
# taken in one pass, bytes added to each shared-memory row, threads per block,
# and the shared-memory bytes in front of the tiles
BLOCK_M, BLOCK_N, K_BLOCK, ROW_PAD, THREADS = 32, 128, 512, 16, 256
HEAD_BYTES = 128 + (BLOCK_M + 2 * BLOCK_N) * 4

# kernel launches in this process (plain-version calls are not counted)
launches = 0

IN_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` float32 -> ``(int8 [K, N], per-output-channel scale [N])``,
    symmetric, scale ``max_k |w| / 127``."""
    sw = symmetric_scale(w.abs().amax(0))
    return round_clip_s8(w.float(), sw), sw


def pad_to(v: int, step: int) -> int:
    return v + (-v % step)


def k_blocks(k: int) -> List[Tuple[int, int]]:
    """``(start, length)`` of the K passes of the kernel over ``K_pad``: the
    whole of it up to 512, else blocks of 512 and a shorter last one."""
    k_pad = pad_to(k, K_STEP)
    return [(k0, min(K_BLOCK, k_pad - k0)) for k0 in range(0, k_pad, K_BLOCK)]


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """int8 ``[K, N]`` -> the kernel's ``[N_blocks, slab bytes]``: for each
    block of 128 output channels and each K pass, 128 rows (one per output
    channel, K contiguous) of ``length + 16`` bytes, zeros past K, past N and
    in the 16 padding bytes, so that a pass is one contiguous copy."""
    k, n = wq.shape
    p = F.pad(wq.t(), (0, pad_to(k, K_STEP) - k, 0, pad_to(n, BLOCK_N) - n))
    p = p.reshape(-1, BLOCK_N, p.shape[1])
    slabs = [F.pad(p[:, :, k0 : k0 + kb], (0, ROW_PAD)).flatten(1) for k0, kb in k_blocks(k)]
    return torch.cat(slabs, 1).contiguous()


def unpack_weights(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_weights`: the int8 ``[K, N]`` it was given."""
    rows, at = [], 0
    for _, kb in k_blocks(k):
        size = BLOCK_N * (kb + ROW_PAD)
        rows.append(packed[:, at : at + size].reshape(-1, BLOCK_N, kb + ROW_PAD)[:, :, :kb])
        at += size
    return torch.cat(rows, 2).reshape(-1, pad_to(k, K_STEP))[:n, :k].t().contiguous()


def matmul_plan(lanes: int, m: int, k: int, n: int) -> dict:
    """The launch of ``csrc/qmm.cu`` for ``x [lanes, m, k]`` and ``n`` output
    channels: rows of all lanes on one axis in tiles of 32, output channels
    in blocks of 128, and shared memory for the head, the int8 activation
    tile and the weight slab of one K pass."""
    stride = max((kb for _, kb in k_blocks(k)), default=0) + ROW_PAD
    return {
        "block": (BLOCK_M, BLOCK_N),
        "threads": THREADS,
        "grid": (-(-lanes * m // BLOCK_M), -(-n // BLOCK_N)),
        "k_pad": pad_to(k, K_STEP),
        "smem_bytes": HEAD_BYTES + (BLOCK_M + BLOCK_N) * stride,
    }


def qmm_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 ``xq @ wq`` (int8 operands), computed in float64: every partial
    sum is an integer below 2**53, so the result is exact."""
    return torch.matmul(xq.double(), wq.double()).to(torch.int32)


def qmm_plain(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, sx, bias: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul` on ``x [B, M, K]``."""
    s = lane_scales(sx, x.shape[0], x.device)
    xq = x if x.dtype == torch.int8 else quantize_plain(x, s)
    return epilogue_plain(qmm_acc_plain(xq, wq), s, sw, bias, out_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm.argtypes = [i, i, p, p, p, p, p, p, *[i] * 12, p]
    lib.qmm.restype = i
    lib.qmm_error_string.argtypes = [i]
    lib.qmm_error_string.restype = ctypes.c_char_p
    return lib


def _qmm_cuda(x, wq, sw, sx, bias, out_dtype, packed):
    """The launch: ``x [B, M, K]`` (made contiguous, :func:`dense`), ``sx`` float32 ``[B]``."""
    global launches
    if device_kind(*(t for t in (x, wq, sw, sx, bias, packed) if t is not None)) != "cuda":
        raise ValueError("the kernel takes CUDA tensors only")
    x = dense(x)
    lanes, m, k = x.shape
    n = wq.shape[1]
    if packed is None:
        packed = pack_weights(wq)
    plan = matmul_plan(lanes, m, k, n)
    k_pad = plan["k_pad"]
    slab = BLOCK_N * (k_pad + ROW_PAD * len(k_blocks(k)))
    check_tensor(x, "x", x.dtype, (lanes, m, k))
    check_tensor(packed, "packed", torch.int8, (plan["grid"][1], slab))
    check_tensor(sw, "sw", torch.float32, (n,))
    check_tensor(sx, "sx", torch.float32, (lanes,))
    check_tensor(bias, "bias", torch.float32, (n,))
    if packed.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned")
    if lanes * m >= 2**31 or m * k >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} does not fit the kernel's int indexing")
    out = torch.empty((lanes, m, n), dtype=out_dtype, device=x.device)
    # 16-byte loads need whole vectors per row and an aligned base
    vec = k % (16 if x.dtype == torch.int8 else 8) == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    args = (IN_KINDS[x.dtype], OUT_KINDS[out_dtype], x.data_ptr(), packed.data_ptr(),
            sw.data_ptr(), sx.data_ptr(), bias.data_ptr(), out.data_ptr(), lanes, m, k, k_pad, n,
            int(vec), *plan["block"], plan["threads"], *plan["grid"], plan["smem_bytes"])
    launch(lib.qmm, args, x.device, lib.qmm_error_string)
    launches += 1
    return out


def _qmm_plain_op(x, wq, sw, sx, bias, out_dtype, packed):
    return qmm_plain(x, wq, sw, sx, bias, out_dtype)


def _qmm_fake(x, wq, sw, sx, bias, out_dtype, packed):
    return torch.empty((*x.shape[:2], wq.shape[1]), dtype=out_dtype, device=x.device)


# the operator: the plain version for the CPU key, the kernel for the CUDA key
qmm_op = define_op(
    "quant_matmul(Tensor x, Tensor wq, Tensor sw, Tensor sx, Tensor bias, ScalarType out_dtype, "
    "Tensor? packed) -> Tensor",
    _qmm_plain_op, _qmm_cuda, _qmm_fake)


def quant_matmul(
    x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, sx, bias: torch.Tensor,
    *, out_dtype: torch.dtype = torch.bfloat16, packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``y [B, M, N]`` from ``x [B, M, K]`` (a 2-D ``x`` is one lane) and
    int8 ``wq [K, N]`` with scales ``sw [N]``, per-lane activation scales
    ``sx`` (scalar, ``[1]`` or ``[B]``) and ``bias [N]``."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    if x.dim() != 3 or x.dtype not in IN_KINDS:
        raise TypeError(f"x: expected [B, M, K] int8, bf16 or float32, got {x.dim()}-D {x.dtype}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if wq.dim() != 2 or wq.shape[0] != x.shape[2]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    device_kind(*(t for t in (x, wq, sw, bias, packed) if t is not None))
    refuse_strided(x)
    y = qmm_op(x, wq, sw, lane_scales(sx, x.shape[0], x.device), bias, out_dtype, packed)
    return y[0] if squeeze else y
