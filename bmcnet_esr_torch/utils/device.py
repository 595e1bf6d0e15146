"""Device selection and numerics policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point; a CUDA device that is not there
    raises (the port never carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def strict_fp32() -> None:
    """Full float32 convolutions and matmuls.  cuDNN defaults to TF32
    convolutions (about three decimal digits), which would break the 1e-3
    RMSE parity budget against the released checkpoint."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
