"""GPU tests of bmcnet_esr_torch: the CUDA rasterizer against its plain
version, and the engine and model on the card against the CPU.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from bmcnet_esr_torch.data import DatasetConfig
from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference
from bmcnet_esr_torch.kernels import rasterize
from bmcnet_esr_torch.models import BMCNet
from bmcnet_esr_torch.ops.batch import batch_counts_from_compact, compact_events
from bmcnet_esr_torch.utils import strict_fp32

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    strict_fp32()
    return torch.device("cuda")


def _events(seed, g, n, hw):
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((g, 4, n), np.float32)
    ev[:, 0] = rng.integers(-2, w + 2, (g, n))
    ev[:, 1] = rng.integers(-2, h + 2, (g, n))
    ev[:, 3] = rng.integers(0, 2, (g, n)) * 2 - 1
    ev[:, :, -n // 16:] = 0  # padding tail
    # adversarial events at the front: OOB both sides, fractional, p == 0
    ev[:, 0, :6] = [-0.5, w - 0.5, w, 1e5, 3, 3]
    ev[:, 1, :6] = [2, 2, 2, 2, -1e5, 2]
    ev[:, 3, 5] = 0
    return ev


@pytest.mark.parametrize("hw,n", [((45, 80), 2048), ((180, 320), 32768)])
def test_kernel_bit_exact_against_plain(cuda, hw, n):
    """Integer addends below 2**24: any atomic order gives equal counts."""
    ev = _events(3, 5, n, hw)
    xy, p = (torch.from_numpy(a).to(cuda) for a in compact_events(ev))
    evd = torch.from_numpy(ev).to(cuda)
    before = rasterize.launches
    got = rasterize.counts_from_compact(xy, p, hw)
    got_raw = rasterize.counts_from_events(evd, hw)
    assert rasterize.launches == before + 2
    want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, hw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_raw, want)
    assert torch.equal(got.cpu(), batch_counts_from_compact(xy.cpu(), p.cpu(), hw))


def test_kernel_wrapper_rejects_mixed_devices(cuda):
    xy = torch.zeros((1, 2, 4), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        rasterize.counts_from_compact(xy, torch.zeros((1, 4), dtype=torch.int8), (4, 4))


def test_engine_on_cuda_matches_cpu(cuda):
    """The released checkpoint, in-memory windows at 16x24 -> 64x96: the
    card (TF32 off) against the CPU, per-window MSEs at rtol 1e-4."""
    inp = compact_events(_events(5, 7, 256, (16, 24))[:, None])
    gt = compact_events(_events(6, 6, 4096, (64, 96))[:, None])

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    ckpt = os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz")
    runs = []
    for dev in (cuda, "cpu"):
        model = load_model_for_inference(ckpt, 4, variant="plain", device=dev)
        eng = InferenceEngine(model, DatasetConfig(scale=4), chunk_size=4, visualize=False,
                              device=dev, extra_metrics=("psnr",))
        before = rasterize.launches
        runs.append(eng.infer_windows(load_chunk, 6, (16, 24), (64, 96), return_per_window=True))
        assert (rasterize.launches > before) == (dev == cuda)
    for key in ("esr_mse", "bicubic_mse"):
        np.testing.assert_allclose(runs[0]["per_window"][key], runs[1]["per_window"][key],
                                   rtol=1e-4, atol=1e-7)
    assert runs[0]["esr_psnr"] == pytest.approx(runs[1]["esr_psnr"], rel=1e-4)


def test_batched_model_equals_solo_on_cuda(cuda):
    """Two streams in one batch against each stream alone, 3 recurrent
    steps of the full model at full width (float32, TF32 off).  Not
    bit-exact on the card: cuDNN picks its convolution algorithm by batch
    size, so the sums are taken in another order.  Measured on an H100
    (torch 2.11, CUDA 12.8): max |d| / max |x| = 1.1e-6 over all outputs.
    Bound: below 1e-5 of each output's largest magnitude (printed)."""
    m = BMCNet(scale=4, generator=torch.Generator().manual_seed(0))
    m = m.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.from_numpy(
        np.random.default_rng(7).poisson(0.3, (3, 2, 2, 45, 80, 2)).astype(np.float32)
    ).to(cuda)
    with torch.inference_mode():
        st2 = m.init_state(2, 45, 80)
        st1 = [m.init_state(1, 45, 80) for _ in range(2)]
        for xs in x:
            st2 = m(xs, *st2)
            st1 = [m(xs[j : j + 1], *st1[j]) for j in range(2)]
    worst = 0.0
    for j in range(2):
        for a, b in zip(st2, st1[j]):
            worst = max(worst, float((a[j : j + 1] - b).abs().max() / b.abs().max()))
    print(f"batched vs solo on {torch.cuda.get_device_name(0)}: max |d| / max |x| = {worst:.3e}")
    assert worst < 1e-5
