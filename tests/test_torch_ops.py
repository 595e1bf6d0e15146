"""Port parity: bmcnet_esr_torch's event ops, rasterizer, resize, shuffle,
metrics and renderer against the JAX package on the same numpy inputs.

Rasterization is exact (every addend is an integer), so those comparisons
are bit-for-bit.  Resize and metrics compare float32 arithmetic done in a
different order: tolerances are stated per test.  The kernel itself is
tested on the GPU by tests/test_torch_cuda.py.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

import jax.numpy as jnp

from bmcnet_esr_tpu.losses import restore as jrestore
from bmcnet_esr_tpu.ops import batch as jbatch
from bmcnet_esr_tpu.ops import encodings as jenc
from bmcnet_esr_tpu.ops import resize as jresize
from bmcnet_esr_tpu.ops import shuffle as jshuffle
from bmcnet_esr_tpu.ops.pallas.rasterize import pallas_events_to_counts
from bmcnet_esr_tpu.vis.events import render_event_count as jrender

from bmcnet_esr_torch.kernels import rasterize
from bmcnet_esr_torch.losses import restore
from bmcnet_esr_torch.ops import batch, encodings, resize, shuffle
from bmcnet_esr_torch.vis.events import render_event_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "orbax", "bmcnet_esr_tpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: torch's default
    of one thread per core oversubscribes the CPU and slows small ops by
    orders of magnitude, so these tests use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _events(seed, b, n, hw, pad=40):
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, 4, n), np.float32)
    ev[:, 0] = rng.integers(-2, w + 2, (b, n))
    ev[:, 1] = rng.integers(-2, h + 2, (b, n))
    ev[:, 2] = rng.random((b, n))
    ev[:, 3] = rng.integers(0, 2, (b, n)) * 2 - 1
    ev[:, :, -pad:] = 0  # padding tail
    return ev


def _adversarial(hw):
    """OOB on every side, fractional, far beyond int16, p == 0, stacked."""
    h, w = hw
    xs = [0, w - 1, w, -1, -0.5, 0.5, w - 0.5, 1e5, -1e5, 32767, 3, 3, 3, 7, 7, 7]
    ys = [0, h - 1, 3, 3, 3, 3, 3, 3, 3, 3, h, -1, 32768, 2, 2, 2]
    ps = [1, -1, 1, -1, 1, -1, 1, 1, -1, 1, 1, -1, 1, 0, -1, -1]
    ev = np.zeros((1, 4, len(xs)), np.float32)
    ev[0, 0], ev[0, 1], ev[0, 3] = xs, ys, ps
    return ev


# -- import hygiene ------------------------------------------------------------


def test_import_loads_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX package."""
    code = (
        "import pkgutil, importlib, sys, bmcnet_esr_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'bmcnet_esr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_import_no_jax():
    """Static scan: no import of JAX or the JAX package in the port or in
    chip_smoke.py, at any nesting level."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bmcnet_esr_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            offenders += [(path, m) for m in mods if m.split(".")[0] in BANNED]
    assert offenders == []


# -- rasterizer ------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(16, 16), (9, 13), (45, 80)])
def test_rasterizer_matches_jax_scatter_and_pallas(hw):
    """Mirror of tests/test_pallas.py::test_matches_xla_scatter: the port's
    raw and compact rasterizers equal the JAX scatter and the Pallas kernel
    (interpret mode) exactly."""
    ev = _events(0, 3, 512, hw)
    want = np.asarray(jbatch.batch_events_to_counts(jnp.asarray(ev), hw))
    pallas = np.asarray(pallas_events_to_counts(jnp.asarray(ev), hw, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got_raw = batch.batch_events_to_counts(_t(ev), hw).numpy()
    xy, p = batch.compact_events(ev)
    got_cmp = batch.batch_counts_from_compact(_t(xy), _t(p), hw).numpy()
    jax_cmp = np.asarray(jbatch.batch_counts_from_compact(jnp.asarray(xy), jnp.asarray(p), hw))
    np.testing.assert_array_equal(got_raw, want)
    np.testing.assert_array_equal(got_cmp, want)
    np.testing.assert_array_equal(got_cmp, jax_cmp)
    assert got_raw.sum() > 0


def test_rasterizer_adversarial_and_lead_dims():
    hw = (8, 12)
    ev = _adversarial(hw)
    stacked = np.concatenate([ev, ev[:, :, ::-1]], 0).reshape(2, 1, 4, -1)  # lead [2, 1]
    want = np.asarray(jbatch.batch_events_to_counts(jnp.asarray(stacked), hw))
    xy, p = batch.compact_events(stacked)
    got = batch.batch_counts_from_compact(_t(xy), _t(p), hw).numpy()
    assert got.shape == (2, 1, 8, 12, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(batch.batch_events_to_counts(_t(stacked), hw).numpy(), want)
    # y flip, channel by sign, value p**2: (x=0, y=0, p=+1) -> row H-1, ch 0
    assert want[0, 0, 7, 0, 0] == 1 and want[0, 0, 0, 11, 1] == 1
    assert want.sum() == 12  # per window 10 of the 16 events are out of range or p == 0


_coords = hnp.arrays(np.float32, (64,), elements=st.one_of(
    st.just(0.0),
    st.floats(0.0009765625, 1e5, width=32),
    st.floats(-1e5, -0.0009765625, width=32),
))
_pol = hnp.arrays(np.float32, (64,), elements=st.sampled_from([-1.0, 0.0, 1.0]))


@given(x=_coords, y=_coords, p=_pol)
@settings(max_examples=30, deadline=None)
def test_compact_raster_equals_raw_and_jax(x, y, p):
    """Mirror of tests/test_properties.py::TestCompactEquality on the same
    (non-subnormal) domain: raw == compact in the port, and == JAX."""
    ev = np.zeros((1, 4, 64), np.float32)
    ev[0, 0], ev[0, 1], ev[0, 3] = x, y, p
    res = (16, 16)
    want = np.asarray(jbatch.batch_events_to_counts(jnp.asarray(ev), res))
    xy, pc = batch.compact_events(ev)
    np.testing.assert_array_equal(batch.batch_events_to_counts(_t(ev), res).numpy(), want)
    np.testing.assert_array_equal(batch.batch_counts_from_compact(_t(xy), _t(pc), res).numpy(), want)


def test_compact_events_matches_jax_bit_for_bit():
    ev = np.concatenate([_events(1, 2, 64, (9, 13), pad=8), np.tile(_adversarial((9, 13)), (2, 1, 4))], 2)
    ev[0, 0, :3] = [-1e-45, 65536.0, -40000.0]  # subnormal and int16 overflow, both sides
    for got, want in zip(batch.compact_events(ev), jbatch.compact_events(ev)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_rasterizer_wrapper_rejects_bad_inputs():
    xy = torch.zeros((2, 2, 8), dtype=torch.int16)
    p = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        rasterize.counts_from_compact(xy.float(), p, (4, 4))
    with pytest.raises(TypeError):
        rasterize.counts_from_compact(xy, p.short(), (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        rasterize.counts_from_compact(xy.transpose(0, 2).contiguous().transpose(0, 2), p, (4, 4))
    with pytest.raises(ValueError, match="shape"):
        rasterize.counts_from_compact(xy, p[:, :4].contiguous(), (4, 4))
    with pytest.raises(ValueError):
        rasterize.counts_from_events(torch.zeros((2, 3, 8)), (4, 4))
    with pytest.raises(ValueError, match="meta"):
        rasterize.counts_from_compact(xy.to("meta"), p.to("meta"), (4, 4))


def test_cpu_tensors_take_the_plain_version():
    before = rasterize.launches
    ev = _events(2, 2, 128, (9, 13))
    xy, p = batch.compact_events(ev)
    got = rasterize.counts_from_compact(_t(xy), _t(p), (9, 13))
    want = rasterize.counts_plain(_t(xy)[:, 0], _t(xy)[:, 1], _t(p), (9, 13))
    assert torch.equal(got, want)
    assert rasterize.launches == before


# -- single-window encoders ----------------------------------------------------


@pytest.mark.parametrize("flip_y", [True, False])
def test_single_window_encoders_match_jax(flip_y):
    ev = np.concatenate([_events(4, 1, 200, (9, 13))[0], _adversarial((9, 13))[0]], 1)
    xs, ys, ps = ev[0], ev[1], ev[3]
    for jfn, tfn in ((jenc.events_to_image, encodings.events_to_image),
                     (jenc.events_to_channels, encodings.events_to_channels)):
        want = np.asarray(jfn(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ps), (9, 13), flip_y=flip_y))
        got = tfn(_t(xs), _t(ys), _t(ps), (9, 13), flip_y=flip_y).numpy()
        np.testing.assert_array_equal(got, want)


def test_sliding_pairs_matches_jax():
    x = np.random.default_rng(5).random((2, 5, 3, 4, 2)).astype(np.float32)
    for seqn in (2, 3):
        np.testing.assert_array_equal(
            batch.sliding_pairs(_t(x), seqn).numpy(), np.asarray(jbatch.sliding_pairs(jnp.asarray(x), seqn))
        )


# -- shuffle and resize ----------------------------------------------------------


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_channel_order_matches_jax(r):
    rng = np.random.default_rng(6)
    x = rng.random((2, 3, 5, 4, 2 * r * r)).astype(np.float32)
    up = shuffle.pixel_shuffle(_t(x), r).numpy()
    np.testing.assert_array_equal(up, np.asarray(jshuffle.pixel_shuffle(jnp.asarray(x), r)))
    down = shuffle.pixel_unshuffle(_t(up), r).numpy()
    np.testing.assert_array_equal(down, np.asarray(jshuffle.pixel_unshuffle(jnp.asarray(up), r)))
    np.testing.assert_array_equal(down, x)
    # the models use F.pixel_shuffle on NCHW: same order
    nchw = torch.nn.functional.pixel_shuffle(_t(x[0]).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), up[0])


@pytest.mark.parametrize("channel_last", [True, False])
def test_resize_matches_jax(channel_last):
    """Same matrices, two float32 products each: agreement to float32
    round-off (atol 1e-5 on values in [0, 4))."""
    rng = np.random.default_rng(7)
    shape = (2, 6, 10, 2) if channel_last else (2, 6, 10)
    x = (rng.random(shape) * 4).astype(np.float32)
    xj = jnp.asarray(x)
    cases = [
        (resize.resize_bicubic(_t(x), (24, 40), channel_last=channel_last),
         jresize.resize_bicubic(xj, (24, 40), channel_last=channel_last)),
        (resize.resize_bicubic(_t(x), (4, 7), channel_last=channel_last),
         jresize.resize_bicubic(xj, (4, 7), channel_last=channel_last)),
        (resize.resize_bilinear(_t(x), (9, 15), channel_last=channel_last),
         jresize.resize_bilinear(xj, (9, 15), channel_last=channel_last)),
        (resize.upsample_bilinear(_t(x), 4, channel_last=channel_last),
         jresize.upsample_bilinear(xj, 4, channel_last=channel_last)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_resize_bf16_promotes_to_float32_like_jax():
    x = np.random.default_rng(8).random((1, 4, 6, 2)).astype(np.float32)
    got = resize.upsample_bilinear(_t(x).bfloat16(), 2)
    want = jresize.upsample_bilinear(jnp.asarray(x).astype(jnp.bfloat16), 2)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_bicubic_is_torch_interpolate():
    """The matrices reproduce F.interpolate(bicubic, align_corners=False),
    Keys A=-0.75 (atol 1e-5, float32 round-off)."""
    x = torch.from_numpy(np.random.default_rng(9).random((1, 2, 6, 10)).astype(np.float32))
    want = torch.nn.functional.interpolate(x, size=(24, 40), mode="bicubic", align_corners=False)
    got = resize.resize_bicubic(x, (24, 40), channel_last=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# -- metrics and renderer ---------------------------------------------------------


def test_restore_metrics_match_jax():
    """float32 reductions in another order: rtol 1e-5."""
    rng = np.random.default_rng(10)
    a = (rng.random((2, 20, 24)) * 3).astype(np.float32)
    b = (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)
    ta, tb, ja, jb = _t(a), _t(b), jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (restore.mse_loss(ta, tb), jrestore.mse_loss(ja, jb)),
        (restore.psnr(ta, tb, 3.0), jrestore.psnr(ja, jb, 3.0)),
        (restore.ssim(ta, tb, 3.0), jrestore.ssim(ja, jb, 3.0)),
        (restore.psnr_metric(ta, tb), jrestore.psnr_metric(ja, jb)),
        (restore.ssim_metric(ta, tb), jrestore.ssim_metric(ja, jb)),
        (restore.psnr_metric(ta[0] / 3, tb[0] / 3), jrestore.psnr_metric(ja[0] / 3, jb[0] / 3)),
        (restore.ssim_metric(ta[0], tb[0]), jrestore.ssim_metric(ja[0], jb[0])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("scheme", ["blue_red", "green_red", "gray"])
def test_renderer_matches_jax(scheme):
    cnt = np.random.default_rng(11).poisson(0.7, (12, 16, 2)).astype(np.float32)
    for black in (False, True):
        for norm in (True, False):
            np.testing.assert_array_equal(
                render_event_count(cnt, scheme, black, norm), jrender(cnt, scheme, black, norm)
            )
