"""GPU tests of bmcnet_esr_torch: the CUDA kernels (rasterizer, quantize_act,
quant_matmul, quant_conv3x3) against their plain versions, and the engine
and models on the card against the CPU and batched against solo.

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
from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize
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
    """Integer counts below 2**24: any order of the adds gives equal counts."""
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


@pytest.mark.parametrize("name,g,n,hw,route", [
    ("hot pixel", 4, 32768, (180, 320), "band"),
    ("one window", 1, 32768, (180, 320), "band"),
    ("one row", 5, 2048, (1, 320), "band"),
    ("N odd, W odd", 3, 2047, (9, 13), "band"),
    ("N = 4 mod 8", 3, 2044, (45, 80), "band"),
    ("one pixel", 2, 512, (1, 1), "band"),
    ("no events", 2, 0, (45, 80), "band"),
    ("a row larger than shared memory", 2, 4096, (2, 30000), "event"),
])
def test_rasterizer_writes_every_element_of_a_garbage_output(cuda, name, g, n, hw, route):
    """Nothing zero-fills the output: into a buffer full of NaN, the band
    kernel (and, where the plan takes it, the per-event kernel) gives the
    plain version's counts bit for bit, one launch a call."""
    ev = _events(11, g, max(n, 16), hw)[:, :, :n]
    if name == "hot pixel":
        ev[:, 0], ev[:, 1] = 7, 9
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert rasterize.raster_plan(g, n, *hw, True, sms=sms)["route"] == route
    xy, p = (torch.from_numpy(a).to(cuda) for a in compact_events(ev))
    evd = torch.from_numpy(ev).to(cuda)
    want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, hw)
    junk = [torch.full((g, *hw, 2), float("nan"), device=cuda) for _ in range(2)]
    before = rasterize.launches
    got = rasterize.counts_from_compact(xy, p, hw, out=junk[0])
    got_raw = rasterize.counts_from_events(evd, hw, out=junk[1])
    fresh = rasterize.counts_from_compact(xy, p, hw)
    assert rasterize.launches == before + 3
    torch.cuda.synchronize()
    assert got.data_ptr() == junk[0].data_ptr()
    assert torch.equal(got, want) and torch.equal(got_raw, want) and torch.equal(fresh, want)


def test_rasterizer_rejects_a_wrong_output_buffer(cuda):
    xy = torch.zeros((1, 2, 4), dtype=torch.int16, device=cuda)
    p = torch.zeros((1, 4), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="out: expected"):
        rasterize.counts_from_compact(xy, p, (4, 4), out=torch.zeros((1, 4, 5, 2), device=cuda))
    with pytest.raises(TypeError, match="out: expected"):
        rasterize.counts_from_compact(xy, p, (4, 4), out=torch.zeros((1, 4, 4, 2), device=cuda).half())


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


def _act(rng, shape, dev, dtype=torch.bfloat16):
    return torch.from_numpy(rng.normal(0, 2.0, shape).astype(np.float32)).to(dev).to(dtype)


def _scales(rng, b, dev):
    return torch.from_numpy((rng.uniform(3.0, 9.0, b) / 127).astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,hw,c", [(1, (45, 80), 131), (4, (45, 80), 128), (3, (7, 13), 416)])
def test_quantize_act_bit_exact_against_plain(cuda, b, hw, c):
    rng = np.random.default_rng(1)
    x, sx = _act(rng, (b, *hw, c), cuda), _scales(rng, b, cuda)
    for relu in (False, True):
        before = quantize.launches
        got = quantize.quantize_act(x, sx, relu)
        assert quantize.launches == before + 1
        assert torch.equal(got, quantize.quantize_plain(x, sx, relu))
    assert torch.equal(quantize.quantize_act(x.float(), sx), quantize.quantize_plain(x, sx))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,skip", [((3, 1, 1, 131), 0), ((3, 2, 3, 131), 0), ((3, 1, 1, 7), 0),
                                        ((2, 7, 13, 129), 0), ((8, 45, 80, 128), 0),
                                        ((2, 9, 5, 37), 1), ((1, 1, 1, 65000), 3)])
def test_quantize_act_head_and_tail_bit_exact_against_plain(cuda, dtype, shape, skip):
    """Lanes that start off a 16-byte boundary (a scalar head, whole units,
    a scalar tail), eight lanes, and views ``skip`` elements into a buffer
    (input and output share no boundary: no vector part at all), with
    half-steps of the scale, zeros and -0.0 among the values."""
    rng = np.random.default_rng(8)
    n = int(np.prod(shape))
    flat = _act(rng, (skip + n,), cuda, dtype)
    sx = _scales(rng, shape[0], cuda)
    steps = (torch.arange(-130, 131, device=cuda) + 0.5) * sx[0]
    k = min(n // 2, steps.numel())
    flat[skip : skip + k] = steps[:k].to(dtype)
    flat[skip + 1 :: 7] = 0.0
    flat[skip + 2 :: 13] = -0.0
    x = flat[skip:].view(shape)
    for relu in (False, True):
        before = quantize.launches
        got = quantize.quantize_act(x, sx, relu)
        assert quantize.launches == before + 1
        assert torch.equal(got, quantize.quantize_plain(x, sx, relu))


@pytest.mark.parametrize("scale", [6.0 / 127.0, 0.0371, 2.0**-4, 1e-12 / 127.0, 3.0e5])
def test_quantize_act_every_bf16_value_as_plain(cuda, scale):
    """Every finite bf16 value through the vector body (the shortcut of
    ``quantize8`` and its fallback) and, as a view off the boundary, through
    the scalar route, with and without the ReLU."""
    bits = torch.arange(65536, dtype=torch.int32, device=cuda).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    sx = torch.tensor([scale], device=cuda)
    for xin in (x[: x.numel() // 16 * 16].view(1, 1, -1, 16), x[3:].view(1, 1, 1, -1)):
        for relu in (False, True):
            assert torch.equal(quantize.quantize_act(xin, sx, relu),
                               quantize.quantize_plain(xin, sx, relu))


@pytest.mark.parametrize("b,m,k,n", [(1, 3600, 128, 128), (4, 3600, 256, 128), (2, 91, 131, 128),
                                     (8, 3600, 128, 128), (2, 189, 640, 160), (3, 1, 128, 24)])
def test_quant_matmul_bit_exact_against_plain(cuda, b, m, k, n):
    rng = np.random.default_rng(2)
    x, sx = _act(rng, (b, m, k), cuda), _scales(rng, b, cuda)
    wq, sw = qmm.quantize_weights(_act(rng, (k, n), cuda, torch.float32) * 0.05)
    bias = _act(rng, (n,), cuda, torch.float32)
    for xin in (x, quantize.quantize_plain(x, sx)):
        for out_dtype in (torch.bfloat16, torch.float32):
            got = qmm.quant_matmul(xin, wq, sw, sx, bias, out_dtype=out_dtype)
            assert torch.equal(got, qmm.qmm_plain(xin, wq, sw, sx, bias, out_dtype))


@pytest.mark.parametrize("b,hw,cin,cout", [
    (1, (45, 80), 150, 128), (4, (45, 80), 416, 128), (2, (45, 80), 256, 32), (3, (7, 13), 131, 8),
    (8, (45, 80), 128, 128), (2, (1, 1), 150, 128), (2, (2, 3), 128, 32), (2, (9, 21), 256, 160),
    (2, (9, 21), 640, 32),
])
def test_quant_conv3x3_bit_exact_against_plain(cuda, b, hw, cin, cout):
    """Every channel count of the main path, eight lanes, images smaller
    than one tile, a second and ragged block of output channels (160) and
    more input channels than one staged halo block holds (640)."""
    rng = np.random.default_rng(3)
    x, sx, se = _act(rng, (b, *hw, cin), cuda), _scales(rng, b, cuda), _scales(rng, b, cuda)
    wq, sw = qconv.quantize_weights3x3(_act(rng, (3, 3, cin, cout), cuda, torch.float32) * 0.02)
    bias = _act(rng, (cout,), cuda, torch.float32)
    xq = quantize.quantize_plain(x, sx)
    for xin in (x, x.float(), xq):
        got = qconv.quant_conv3x3(xin, wq, sw, sx, bias)
        assert torch.equal(got, qconv.qconv3x3_plain(xin, wq, sw, sx, bias))
    got = qconv.quant_conv3x3(xq, wq, sw, sx, bias, emit_scale=se, emit_relu=True)
    assert torch.equal(got, qconv.qconv3x3_plain(xq, wq, sw, sx, bias, emit_scale=se, emit_relu=True))


def test_int8_kernels_on_relu_output_with_negative_zeros(cuda):
    """A ReLU output: more than half zeros, some of them -0.0.  The kernels
    quantize a zero without a division; the plain version divides."""
    rng = np.random.default_rng(5)
    x, sx = torch.relu(_act(rng, (2, 45, 80, 128), cuda)), _scales(rng, 2, cuda)
    x[:, ::3, 1::2, ::5] = -0.0
    assert float((x == 0).float().mean()) > 0.5 and bool(torch.signbit(x).any())
    wq, sw = qconv.quantize_weights3x3(_act(rng, (3, 3, 128, 128), cuda, torch.float32) * 0.02)
    wq1, sw1 = qmm.quantize_weights(_act(rng, (128, 128), cuda, torch.float32) * 0.05)
    bias = _act(rng, (128,), cuda, torch.float32)
    for xin in (x, x.float()):
        assert torch.equal(qconv.quant_conv3x3(xin, wq, sw, sx, bias),
                           qconv.qconv3x3_plain(xin, wq, sw, sx, bias))
        assert torch.equal(qmm.quant_matmul(xin.view(2, -1, 128), wq1, sw1, sx, bias),
                           qmm.qmm_plain(xin.view(2, -1, 128), wq1, sw1, sx, bias))


@pytest.mark.parametrize("scale", [6.0 / 127.0, 0.0371, 2.0**-4, 1e-12 / 127.0, 3.0e5])
def test_int8_kernels_quantize_every_bf16_value_as_plain(cuda, scale):
    """Every finite bf16 value, through both kernels' fused quantization at
    one scale, against the plain version's division: the kernels' shortcut
    around the division and its fallback give the same int8 everywhere."""
    bits = torch.arange(65536, dtype=torch.int32, device=cuda).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    x = torch.cat([x, x.new_zeros(-x.numel() % 128)]).view(1, -1, 128)
    sx = torch.tensor([scale], device=cuda)
    rng = np.random.default_rng(6)
    wq1, sw1 = qmm.quantize_weights(_act(rng, (128, 128), cuda, torch.float32))
    bias = torch.zeros(128, device=cuda)
    assert torch.equal(qmm.quant_matmul(x, wq1, sw1, sx, bias, out_dtype=torch.float32),
                       qmm.qmm_plain(x, wq1, sw1, sx, bias, torch.float32))
    xi = x.view(1, 1, -1, 128)
    wq, sw = qconv.quantize_weights3x3(_act(rng, (3, 3, 128, 64), cuda, torch.float32))
    assert torch.equal(qconv.quant_conv3x3(xi, wq, sw, sx, bias[:64], out_dtype=torch.float32),
                       qconv.qconv3x3_plain(xi, wq, sw, sx, bias[:64], torch.float32))


def test_int8_kernels_batched_equal_solo_launches(cuda):
    """A row of the output depends on its own lane only: B lanes in one
    launch equal B launches of one lane, bit for bit."""
    rng = np.random.default_rng(4)
    b = 4
    x, sx = _act(rng, (b, 45, 80, 128), cuda), _scales(rng, b, cuda)
    wq, sw = qconv.quantize_weights3x3(_act(rng, (3, 3, 128, 128), cuda, torch.float32) * 0.02)
    wq1, sw1 = qmm.quantize_weights(_act(rng, (128, 128), cuda, torch.float32) * 0.05)
    bias = _act(rng, (128,), cuda, torch.float32)
    conv = qconv.quant_conv3x3(x, wq, sw, sx, bias)
    mm = qmm.quant_matmul(x.view(b, -1, 128), wq1, sw1, sx, bias)
    for i in range(b):
        assert torch.equal(conv[i : i + 1], qconv.quant_conv3x3(x[i : i + 1], wq, sw, sx[i : i + 1], bias))
        assert torch.equal(mm[i : i + 1], qmm.quant_matmul(x[i : i + 1].view(1, -1, 128), wq1, sw1,
                                                           sx[i : i + 1], bias))


def test_int8_kernels_refuse_nchw_memory(cuda):
    """The kernels take NHWC-contiguous data and never reinterpret NCHW."""
    x = torch.zeros((1, 8, 5, 6), device=cuda).permute(0, 2, 3, 1)  # an NCHW tensor seen as NHWC
    with pytest.raises(ValueError, match="contiguous"):
        quantize.quantize_act(x, 1.0)
    wq, sw = qconv.quantize_weights3x3(torch.ones((3, 3, 8, 4), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        qconv.quant_conv3x3(x, wq, sw, 1.0, torch.zeros(4, device=cuda))


@pytest.mark.parametrize("dtype", ["int8", "int8_pall"])
def test_int8_batched_model_equals_solo_on_cuda(cuda, dtype):
    """Two streams in one batch against each alone, 3 steps of the full
    model at full width on dynamic per-lane scales.  The int8 convolutions
    are per lane by construction (test above), so what differs is the float
    work around them (cuBLAS attention and resize products, reductions and,
    in int8, cuDNN's bf16 1x1 convs, whose algorithms depend on the batch),
    and a bf16 rounding that moves an activation across a quantization step
    then spreads through the recurrence.  Measured on an H100: max |d| /
    max |x| 2.4e-2 (int8) and 5.5e-2 (int8_pall).  Bounds: rel-RMSE below
    1e-2 (a fifth of the int8 serving bound against float32) and max |d| /
    max |x| below 0.2 (both printed)."""
    from bmcnet_esr_torch.inference.engine import INT8_DTYPES

    f32 = BMCNet(scale=4, generator=torch.Generator().manual_seed(0))
    m = BMCNet(scale=4, dtype=torch.bfloat16, quant=INT8_DTYPES[dtype])
    m.load_state_dict(f32.state_dict())
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
    worst = rel = 0.0
    for j in range(2):
        for a, b in zip(st2, st1[j]):
            d, scale = a[j : j + 1].float() - b.float(), float(b.float().abs().max())
            worst = max(worst, float(d.abs().max()) / scale)
            rel = max(rel, float(d.square().mean().sqrt()) / scale)
    print(f"{dtype} batched vs solo on {torch.cuda.get_device_name(0)}: "
          f"max |d| / max |x| = {worst:.3e}, rel-RMSE {rel:.3e}")
    assert rel < 1e-2 and worst < 0.2


# -- training ------------------------------------------------------------------


def _train_batch(seed, b=2, l=9, hw=(45, 80), gt=(180, 320), n=2048):
    """One compact training batch of the NFS recipe's shapes: [B, L] windows."""
    out = {}
    for prefix, size, count in (("inp", hw, n), ("gt", gt, 16 * n)):
        xy, p = compact_events(_events(seed, b * l, count, size).reshape(b, l, 4, count))
        out[f"{prefix}_xy"], out[f"{prefix}_p"] = torch.from_numpy(xy), torch.from_numpy(p)
        seed += 1
    return out


def test_rasterizer_at_training_shapes(cuda):
    """One training batch, B x L = 2 x 9 windows in one call per prefix (the
    train step's shapes), bit-exact against the plain version in compact and
    raw form, into outputs full of NaN."""
    from bmcnet_esr_torch.ops.batch import batch_events_to_counts, counts_from_batch

    batch = _train_batch(11)
    for prefix, hw, n in (("inp", (45, 80), 2048), ("gt", (180, 320), 32768)):
        xy, p = batch[f"{prefix}_xy"].to(cuda), batch[f"{prefix}_p"].to(cuda)
        before = rasterize.launches
        got = counts_from_batch({f"{prefix}_xy": xy, f"{prefix}_p": p}, prefix, hw)
        assert rasterize.launches == before + 1 and tuple(got.shape) == (2, 9, *hw, 2)
        want = rasterize.counts_plain(xy.view(18, 2, n)[:, 0], xy.view(18, 2, n)[:, 1],
                                      p.view(18, n), hw)
        nan = torch.full((18, *hw, 2), float("nan"), device=cuda)
        into = rasterize.counts_from_compact(xy.view(18, 2, n), p.view(18, n), hw, out=nan)
        raw = torch.zeros((2, 9, 4, n), device=cuda)
        raw[:, :, :2], raw[:, :, 3] = xy.float(), p.float()
        got_raw = batch_events_to_counts(raw, hw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(18, *hw, 2), want) and torch.equal(into, want)
        assert torch.equal(got_raw.view(18, *hw, 2), want)


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_train_step_on_cuda_matches_cpu(cuda, variant):
    """One train step (BPTT over 8 window pairs, backward, Adam with amsgrad
    and weight decay) of a narrow model at the NFS shapes, on the card and on
    the CPU from the same parameters and batch.  float32 with TF32 off; the
    two differ by summation order: loss and gradient norm to rtol 1e-5, the
    parameters after the update to 2e-6 absolute (2 % of an update of the
    learning rate, 1e-4: a first Adam update is g / (|g| + eps) times it, so
    an element whose gradient is near eps moves by its rounding)."""
    from bmcnet_esr_torch.models import BMCNetPlain
    from bmcnet_esr_torch.training import build_optimizer, init_train_state, make_train_step

    cls = BMCNetPlain if variant == "plain" else BMCNet
    base = cls(scale=4, n_c=16, n_b=2, generator=torch.Generator().manual_seed(1))
    batch = _train_batch(21)
    step = make_train_step((45, 80), (180, 320), use_remat=False)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        m = cls(scale=4, n_c=16, n_b=2)
        m.load_state_dict(base.state_dict())
        m = m.to(dev, memory_format=torch.channels_last)
        opt, sched = build_optimizer(m.parameters(), {"name": "Adam", "args": {
            "lr": 1e-4, "weight_decay": 1e-5, "amsgrad": True}}, {}, {})
        state = init_train_state(m, opt, sched)
        before = rasterize.launches
        state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
        if dev.type == "cuda":
            assert rasterize.launches == before + 2  # one per prefix
        out[dev.type] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.detach().cpu() for n, p in m.named_parameters()})
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    assert mg["train_loss"] == pytest.approx(mc["train_loss"], rel=1e-5)
    assert mg["grad_norm"] == pytest.approx(mc["grad_norm"], rel=1e-5)
    for name in pc:
        torch.testing.assert_close(pg[name], pc[name], rtol=0, atol=2e-6, msg=name)


# -- live serving: the pool on the card ---------------------------------------


def _serving_windows(seed, count, n=1500, hw=(16, 24)):
    ev = _events(seed, count, n, hw)
    ev[:, 2] = np.sort(np.random.default_rng(seed).random((count, n)), axis=1)
    return list(ev)


def _tiny_pool(cuda, **kw):
    from bmcnet_esr_torch.inference import StreamPool

    model = BMCNet(scale=2, n_c=8, n_b=2, generator=torch.Generator().manual_seed(0))
    return StreamPool(model, None, (16, 24), window_size=2048, device=cuda, **kw)


@pytest.mark.parametrize("wire", ["f32", "f16", "i8"])
def test_pool_fetch_into_nan_pinned_buffers_equals_a_device_copy(cuda, wire, monkeypatch):
    """A pool tick's fetch fills pinned host buffers (here pre-filled with
    NaN, or -1 for int8) whole, equal to a blocking copy of the device
    encoding, with fetch_chunks=2."""
    from bmcnet_esr_torch.inference import assemble_fetch, streaming

    encs = []
    wire_encode = streaming._wire_encode

    def recording(pred, out_wire):
        enc = wire_encode(pred, out_wire)
        encs.append(enc)
        return enc

    def junk_pinned(shape, dtype):
        fill = -1 if dtype == torch.int8 else float("nan")
        return torch.full(shape, fill, dtype=dtype).pin_memory()

    monkeypatch.setattr(streaming, "_wire_encode", recording)
    monkeypatch.setattr(streaming, "_pinned_empty", junk_pinned)
    pool = _tiny_pool(cuda, slots=4, out_wire=wire, fetch_chunks=2)
    slots = [pool.attach() for _ in range(3)]
    wins = _serving_windows(1, 6)
    pool.push_async({s: wins[i] for i, s in enumerate(slots)})
    _, fetch = pool.push_async({s: wins[3 + i] for i, s in enumerate(slots)})
    host = assemble_fetch(fetch.get())
    want = encs[-1]
    for got, ref in zip(*(x if isinstance(x, tuple) else (x,) for x in (host, want))):
        ref = ref.float().cpu().numpy() if ref.dtype == torch.bfloat16 else ref.cpu().numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quant", [False, "pall"])
def test_pool_deep_tick_equals_shallow_ticks_on_cuda(cuda, quant):
    """A deep tick of K=4 equals 4 shallow ticks of the same pool width on
    the card, bit for bit, with one rasterizer launch per tick."""
    from bmcnet_esr_torch.inference import StreamPool, assemble_fetch
    from bmcnet_esr_torch.models import calibrate_act_scales

    model = BMCNet(scale=2, n_c=8, n_b=2, quant=quant, dtype=torch.bfloat16 if quant else
                   torch.float32, generator=torch.Generator().manual_seed(0)).to(cuda)
    if quant:
        pairs = torch.rand((2, 1, 2, 16, 24, 2), device=cuda).round()
        calibrate_act_scales(model, pairs, model.init_state(1, 16, 24, device=cuda))
    pools = [StreamPool(model, None, (16, 24), slots=4, window_size=2048, device=cuda)
             for _ in range(2)]
    wins = {0: _serving_windows(2, 4), 2: _serving_windows(3, 3)}
    for p in pools:
        p.attach(), p.attach(), p.attach()
    before = rasterize.launches
    _, deep = pools[0].push_async_deep(wins, 4)
    assert rasterize.launches == before + 1
    deep = assemble_fetch(deep.get(), deep=True)
    for j in range(4):
        _, f = pools[1].push_async({s: w[j] for s, w in wins.items() if j < len(w)})
        np.testing.assert_array_equal(deep[j], f.get())
    assert rasterize.launches == before + 5
    for a, b in zip(pools[0]._carry + (pools[0]._prev,), pools[1]._carry + (pools[1]._prev,)):
        assert torch.equal(a, b)


def test_pool_fetch_waits_for_its_own_tick_only(cuda):
    """The fetch of tick 1 returns while tick 2, dispatched after it, is
    still held on the pool's stream behind a long sleep: it waits on tick
    1's event, not on the stream."""
    pool = _tiny_pool(cuda, slots=2)
    a = pool.attach()
    wins = _serving_windows(4, 2)
    _, first = pool.push_async({a: wins[0]})
    first.get()
    _, f1 = pool.push_async({a: wins[1]})
    with torch.cuda.stream(pool._groups[0].stream):
        torch.cuda._sleep(int(3e9))  # about 1.5 s of the card's clock
    _, f2 = pool.push_async({a: wins[0]})
    f1.get()
    assert not f2.is_ready()
    f2.get()
    assert f2.is_ready()


# -- operators and serving bundles -------------------------------------------------


def test_operators_take_the_cuda_registration(cuda):
    """Each operator called on CUDA tensors runs its CUDA registration (the
    kernel's launch count moves by one, never the plain version's) and
    equals the CPU registration on the same inputs."""
    rng = np.random.default_rng(11)
    ev = _events(11, 2, 256, (9, 13))
    xy, p = (torch.from_numpy(a) for a in compact_events(ev))
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 40)).astype(np.float32)).bfloat16()
    sx = torch.tensor([0.02, 0.03])
    wq3, sw3 = qconv.quantize_weights3x3(torch.from_numpy(
        rng.normal(0, 0.1, (3, 3, 40, 24)).astype(np.float32)))
    wq1, sw1 = qmm.quantize_weights(torch.from_numpy(rng.normal(0, 0.1, (40, 24)).astype(np.float32)))
    bias = torch.from_numpy(rng.normal(0, 0.1, 24).astype(np.float32))
    ops = torch.ops.bmcnet
    cases = [
        (rasterize, ops.rasterize_counts_compact.default, (xy, p, 9, 13)),
        (rasterize, ops.rasterize_counts_f32.default, (torch.from_numpy(ev), 9, 13)),
        (quantize, ops.quantize_act.default, (x, sx, True)),
        (qmm, ops.quant_matmul.default, (x.view(2, 30, 40), wq1, sw1, sx, bias, torch.float32, None)),
        (qconv, ops.quant_conv3x3.default,
         (x, wq3, sw3, sx, bias, torch.bfloat16, torch.tensor([0.5, 0.25]), True, None)),
    ]
    for mod, op, args in cases:
        want = op(*args)
        on_card = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args)
        before = mod.launches
        got = op(*on_card)
        torch.cuda.synchronize()
        assert mod.launches == before + 1, op
        assert got.is_cuda and torch.equal(got.cpu(), want), op


@pytest.mark.parametrize("dtype", ["float32", "int8_pall"])
def test_bundle_on_cuda_equals_streaming_sr(cuda, dtype, tmp_path):
    """A bundle exported and served on the card equals StreamingSR on the
    card bit for bit (same operators, same cuDNN calls); int8_pall on static
    scales, one rasterizer launch and the model's int8 launches a push."""
    from bmcnet_esr_torch.inference import ExportedStream, StreamingSR, export_serving_bundle
    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.models import calibrate_act_scales

    hw, n = (12, 16), 256
    m = BMCNet(scale=2, n_c=16, n_b=2, dtype=DTYPES.get(dtype, torch.bfloat16),
               quant=INT8_DTYPES.get(dtype, False), generator=torch.Generator().manual_seed(0))
    m = m.to(cuda, memory_format=torch.channels_last).eval()
    if m.quant:
        pairs = torch.from_numpy(
            np.random.default_rng(3).poisson(0.7, (3, 1, 2, *hw, 2)).astype(np.float32)).to(cuda)
        calibrate_act_scales(m, pairs, m.init_state(1, *hw))
    path = export_serving_bundle(m, None, str(tmp_path / dtype), hw, n, device=cuda)
    served = ExportedStream(path, device=cuda)
    live = StreamingSR(m, None, hw, n, device=cuda)
    for i, ev in enumerate(_events(5, 4, n, hw)):
        want = live.push(ev)
        before = (rasterize.launches, qconv.launches)
        got = served.push(ev)
        assert rasterize.launches == before[0] + 1
        assert qconv.launches - before[1] == (51 if m.quant else 0)  # 11 + 20 * n_b 3x3 sites
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0], want, err_msg=f"window {i}")



def test_float32_bundle_in_a_fresh_process_equals_streaming_sr(cuda, tmp_path):
    """A consumer process that imports no model code and starts with TF32 on
    serves a float32 bundle bit for bit as ``StreamingSR`` does here:
    ``ExportedStream`` sets the float32 policy itself."""
    import subprocess
    import sys

    from bmcnet_esr_torch.inference import StreamingSR, export_serving_bundle

    hw, n = (12, 16), 256
    m = BMCNet(scale=2, n_c=16, n_b=2, generator=torch.Generator().manual_seed(0))
    m = m.to(cuda, memory_format=torch.channels_last).eval()
    path = export_serving_bundle(m, None, str(tmp_path / "f32"), hw, n, device=cuda)
    windows = _events(5, 4, n, hw)
    np.save(tmp_path / "windows.npy", windows)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "from bmcnet_esr_torch.inference.export import ExportedStream\n"
        f"s = ExportedStream({path!r}, device='cuda')\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        f"wins = np.load({str(tmp_path / 'windows.npy')!r})\n"
        "preds = [s.push(w) for w in wins]\n"
        f"np.save({str(tmp_path / 'preds.npy')!r}, np.stack([p[0] for p in preds[1:]]))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bmcnet_esr_tpu')\n"
        "             or m.startswith('bmcnet_esr_torch.models'))\n"
        "print('BAD', bad)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=repo), cwd=repo, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    live = StreamingSR(m, None, hw, n, device=cuda)
    want = [live.push(ev) for ev in windows][1:]
    np.testing.assert_array_equal(np.load(tmp_path / "preds.npy"), np.stack(want))


# -- data parallelism on the card ---------------------------------------------


def test_one_rank_nccl_step_equals_the_plain_step_on_cuda(cuda, monkeypatch):
    """A 1-rank NCCL group: ``make_parallel_train_step`` (one all-reduce of
    the gradient bucket, divided by 1) equals ``make_train_step`` bit for
    bit over two steps, channels-last parameters included."""
    import socket

    import torch.distributed as dist

    from bmcnet_esr_torch.parallel import (
        init_distributed,
        make_parallel_train_step,
        make_process_mesh,
    )
    from bmcnet_esr_torch.training import build_optimizer, init_train_state, make_train_step

    def state():
        m = BMCNet(scale=4, n_c=16, n_b=2, generator=torch.Generator().manual_seed(2))
        m = m.to(cuda, memory_format=torch.channels_last)
        opt, sched = build_optimizer(m.parameters(), {"name": "Adam", "args": {
            "lr": 1e-4, "weight_decay": 1e-5, "amsgrad": True}}, {}, {})
        return init_train_state(m, opt, sched)

    batches = [{k: v.to(cuda) for k, v in _train_batch(s).items()} for s in (31, 41)]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    runs = []
    init_distributed(cuda, init_method=f"tcp://localhost:{port}")
    try:
        for step in (make_train_step((45, 80), (180, 320), use_remat=False),
                     make_parallel_train_step((45, 80), (180, 320), make_process_mesh(),
                                              use_remat=False)):
            st, metrics = state(), []
            for b in batches:
                st, m = step(st, b)
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, [p.detach().clone() for p in st.model.parameters()]))
    finally:
        dist.destroy_process_group()
    (m1, p1), (m2, p2) = runs
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("dtype", ["float32", "int8_pall"])
def test_engine_mesh_of_two_on_one_card_equals_solo_rollouts(cuda, dtype):
    """``make_mesh(2, devices=[cuda:0] * 2)``: each shard, a batch-1 rollout
    on its own replica and stream, equals its stream's solo rollout bit for
    bit (the int8 scales calibrated per lane)."""
    from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
    from bmcnet_esr_torch.parallel import make_mesh

    inp = compact_events(_events(8, 2 * 7, 256, (16, 24)).reshape(7, 2, 4, 256))
    gt = compact_events(_events(9, 2 * 6, 4096, (64, 96)).reshape(6, 2, 4, 4096))

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    def lane(j):
        return lambda pos, steps: tuple(tuple(a[:, j : j + 1] for a in part)
                                        for part in load_chunk(pos, steps))

    m = BMCNet(scale=4, n_c=16, n_b=2, dtype=DTYPES.get(dtype, torch.bfloat16),
               quant=INT8_DTYPES.get(dtype, False), generator=torch.Generator().manual_seed(3))
    sharded = InferenceEngine(m, DatasetConfig(scale=4), chunk_size=4, visualize=False,
                              mesh=make_mesh(2, devices=[cuda, cuda]), device=cuda)
    solo = InferenceEngine(m, DatasetConfig(scale=4), chunk_size=4, visualize=False,
                           device=cuda)
    before = rasterize.launches
    got = sharded.infer_windows_batch(load_chunk, [6, 6], (16, 24), (64, 96),
                                      return_per_window=True)
    assert rasterize.launches > before
    for j in (0, 1):
        want = solo.infer_windows(lane(j), 6, (16, 24), (64, 96), return_per_window=True)
        for key in ("esr_mse", "bicubic_mse"):
            np.testing.assert_array_equal(got[j]["per_window"][key], want["per_window"][key])
