"""The host side of the port's two int8 tensor-core kernels
(``bmcnet_esr_torch/csrc/qconv.cu`` and ``qmm.cu``), which the CPU can check
without a GPU: the packed weight layouts, the launch plans, the index
arithmetic the convolution kernel copies (halo tile, zero border, per-tap
shifted reads, K split over two warpgroups), the quantization shortcut the
kernels take around the division, and the zero handling against the JAX
package.  Everything here is integer or bit-exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bmcnet_esr_tpu.ops.pallas import quantize as jquantize

from bmcnet_esr_torch.kernels import qconv, qmm, quantize

CONV_CHANNELS = [(128, 128), (131, 128), (150, 128), (172, 128), (416, 128), (256, 32)]
IMAGES = [(45, 80), (7, 13), (1, 1), (33, 17)]


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


# -- packed weights ------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", CONV_CHANNELS + [(700, 160)])
def test_pack_weights3x3_round_trip(cin, cout):
    """``unpack`` gives back ``wq`` exactly; what is not a weight is zero;
    the packed tensor is contiguous, one row per block of output channels,
    and every slab a whole number of 16-byte units."""
    wq = _int8(np.random.default_rng(cin + cout), (3, 3, cin, cout))
    packed = qconv.pack_weights3x3(wq)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (-(-cout // qconv.BLOCK_N), 9 * qconv.BLOCK_N * qmm.pad_to(cin, 32))
    assert torch.equal(qconv.unpack_weights3x3(packed, cin, cout), wq)
    assert int(packed.ne(0).sum()) == int(wq.ne(0).sum())  # padding is zero
    stages = qconv.conv_stages(cin)
    assert all((qconv.BLOCK_N * kc) % 16 == 0 and kc % 32 == 0 for _, _, kc in stages)
    assert sum(kc for _, _, kc in stages) == 9 * qmm.pad_to(cin, 32)


@pytest.mark.parametrize("cin,cout", [(128, 128), (131, 128), (256, 32)])
def test_pack_weights3x3_core_matrix_order(cin, cout):
    """The byte of (output channel n, channel k of a stage) sits where the
    tensor cores' K-major layout without swizzle reads it: 16 bytes of K per
    row, 8 rows per core matrix, the 8 core matrices of a 16-channel chunk
    one after another (128 bytes apart), chunks 1024 bytes apart."""
    rng = np.random.default_rng(3)
    wq = _int8(rng, (3, 3, cin, cout))
    packed = qconv.pack_weights3x3(wq)
    at = 0
    for tap, c0, kc in qconv.conv_stages(cin):
        for _ in range(8):
            n, k = int(rng.integers(0, cout)), int(rng.integers(0, kc))
            blk, nl = divmod(n, qconv.BLOCK_N)
            off = at + (k // 16) * 1024 + (nl // 8) * 128 + (nl % 8) * 16 + k % 16
            want = wq[tap // 3, tap % 3, c0 + k, n] if c0 + k < cin else 0
            assert packed[blk, off] == want
        at += qconv.BLOCK_N * kc


@pytest.mark.parametrize("k,n", [(128, 128), (131, 128), (256, 128), (131, 24), (1100, 200)])
def test_pack_weights_round_trip(k, n):
    wq = _int8(np.random.default_rng(k + n), (k, n))
    packed = qmm.pack_weights(wq)
    blocks = qmm.k_blocks(k)
    slab = sum(qmm.BLOCK_N * (kb + qmm.ROW_PAD) for _, kb in blocks)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (-(-n // qmm.BLOCK_N), slab)
    assert all((qmm.BLOCK_N * (kb + qmm.ROW_PAD)) % 16 == 0 for _, kb in blocks)
    assert torch.equal(qmm.unpack_weights(packed, k, n), wq)
    assert int(packed.ne(0).sum()) == int(wq.ne(0).sum())  # padding is zero
    # row r of the first K pass: output channel r, K contiguous
    kb = blocks[0][1]
    row = packed[0, 5 * (kb + qmm.ROW_PAD) : 6 * (kb + qmm.ROW_PAD)]
    assert torch.equal(row[: min(k, kb)], wq[: min(k, kb), 5])
    assert not row[kb:].any()


# -- launch plans --------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("hw", IMAGES)
def test_conv_plan_covers_every_pixel_once(lanes, hw):
    """Every output pixel of every lane lies in exactly one tile, no tile
    spans two lanes, and the shared memory fits the card, at every channel
    count of the main path."""
    h, w = hw
    for cin, cout in CONV_CHANNELS:
        plan = qconv.conv_plan(lanes, h, w, cin, cout)
        th, tw = plan["tile"]
        ty, tx = plan["tiles"]
        assert plan["grid"] == (lanes * ty * tx, -(-cout // plan["block_n"]))
        assert plan["smem_bytes"] <= qmm.SMEM_LIMIT == 232_448
        assert 2 * 8192 <= plan["stages"] * qconv.STAGE_BYTES  # room for the K halves' exchange
        assert plan["cin_pad"] % 32 == 0 and 0 <= plan["cin_pad"] - cin < 32
    seen = torch.zeros((lanes, h, w), dtype=torch.int32)
    for i in range(plan["grid"][0]):
        lane, tile = divmod(i, ty * tx)  # as the kernel reads blockIdx.x
        y0, x0 = (tile // tx) * th, (tile % tx) * tw
        seen[lane, y0 : y0 + th, x0 : x0 + tw] += 1
    assert bool((seen == 1).all())


def test_conv_plan_fills_the_card_at_one_lane():
    plan = qconv.conv_plan(1, 45, 80, 128, 128)
    assert plan["grid"][0] * plan["grid"][1] >= 114
    assert plan["threads"] == 544 and plan["tile"] == (4, 16) and plan["block_n"] == 64
    # more blocks than multiprocessors: smaller blocks, two to a multiprocessor
    assert qconv.conv_plan(2, 45, 80, 128, 128)["threads"] == 288
    assert qconv.conv_plan(1, 45, 80, 128, 128, sms=100)["threads"] == 288
    # a wider input takes more shared memory
    assert qconv.conv_plan(1, 45, 80, 416, 128)["smem_bytes"] > plan["smem_bytes"]


@pytest.mark.parametrize("lanes,m,k,n", [(1, 3600, 128, 128), (4, 3600, 256, 128),
                                         (3, 91, 131, 24), (2, 189, 640, 160)])
def test_matmul_plan(lanes, m, k, n):
    plan = qmm.matmul_plan(lanes, m, k, n)
    bm, bn = plan["block"]
    gx, gy = plan["grid"]
    assert (gx - 1) * bm < lanes * m <= gx * bm and (gy - 1) * bn < n <= gy * bn
    assert plan["k_pad"] % 32 == 0 and 0 <= plan["k_pad"] - k < 32
    assert plan["smem_bytes"] <= qmm.SMEM_LIMIT
    passes = qmm.k_blocks(k)
    assert sum(kb for _, kb in passes) == plan["k_pad"]
    assert (len(passes) == 1) == (plan["k_pad"] <= qmm.K_BLOCK)  # the whole K in one pass


def test_matmul_plan_fills_the_card_at_one_lane():
    assert qmm.matmul_plan(1, 3600, 128, 128)["grid"] == (113, 1)


# -- the index arithmetic of the convolution kernel ------------------------------


def conv_by_tiles(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The convolution as ``csrc/qconv.cu`` walks it, in plain PyTorch: per
    block the int8 halo tile (zero outside the image and past Cin), then for
    every stage of :func:`conv_stages` the tap-shifted rows of the halo times
    the stage's slab read back from the PACKED weights, K steps of 32 dealt
    alternately to two partial sums that are added at the end."""
    lanes, h, w, cin = xq.shape
    cout = wq.shape[3]
    plan = qconv.conv_plan(lanes, h, w, cin, cout)
    (th, tw), (ty, tx), bn = plan["tile"], plan["tiles"], plan["block_n"]
    packed = qconv.pack_weights3x3(wq).long()
    out = torch.zeros((lanes, h, w, cout), dtype=torch.int64)
    for bx in range(plan["grid"][0]):
        lane, tile = divmod(bx, ty * tx)
        y0, x0 = (tile // tx) * th, (tile % tx) * tw
        halo = torch.zeros((th + 2, tw + 2, plan["cin_pad"]), dtype=torch.int64)
        ys, xs = range(max(y0 - 1, 0), min(y0 + th + 1, h)), range(max(x0 - 1, 0), min(x0 + tw + 1, w))
        halo[ys[0] - y0 + 1 : ys[-1] - y0 + 2, xs[0] - x0 + 1 : xs[-1] - x0 + 2, :cin] = (
            xq[lane, ys[0] : ys[-1] + 1, xs[0] : xs[-1] + 1])
        for by in range(plan["grid"][1]):
            acc = torch.zeros((2, th, tw, bn), dtype=torch.int64)  # the two K halves
            at = kstep = 0
            for tap, c0, kc in qconv.conv_stages(cin):
                slab = packed[by, at : at + bn * kc].reshape(kc // 16, bn // 8, 8, 16)
                at += bn * kc
                a = halo[tap // 3 : tap // 3 + th, tap % 3 : tap % 3 + tw, c0 : c0 + kc]
                for k0 in range(0, kc, 32):
                    # B as the descriptor reads it: chunk k // 16, row group n // 8
                    b = slab[k0 // 16 : k0 // 16 + 2].permute(1, 2, 0, 3).reshape(bn, 32)
                    acc[kstep & 1] += a[:, :, k0 : k0 + 32] @ b.t()
                    kstep += 1
            n0, y1, x1 = by * bn, min(y0 + th, h), min(x0 + tw, w)
            n1 = min(n0 + bn, cout)
            out[lane, y0:y1, x0:x1, n0:n1] = acc.sum(0)[: y1 - y0, : x1 - x0, : n1 - n0]
    return out.to(torch.int32)


@pytest.mark.parametrize("lanes,hw,cin,cout", [(2, (7, 13), 131, 32), (1, (45, 80), 131, 72),
                                               (1, (5, 18), 544, 8)])
def test_conv_by_tiles_equals_plain(lanes, hw, cin, cout):
    rng = np.random.default_rng(11)
    xq, wq = _int8(rng, (lanes, *hw, cin)), _int8(rng, (3, 3, cin, cout))
    assert torch.equal(conv_by_tiles(xq, wq), qconv.conv3x3_acc_plain(xq, wq))


# -- quantization: the kernels' shortcut, and zeros -----------------------------


def shortcut(v: np.ndarray, s: np.float32):
    """``int8_tiles.cuh::q8_shortcut`` in numpy float32: the byte, and whether
    the kernel would fall back to the division (``unsure``)."""
    magic = np.float32(12582912.0)
    with np.errstate(all="ignore"):
        r = np.float32(1.0) / s
        q0 = v * r
        qc = np.minimum(np.maximum(np.where(np.isnan(q0), np.float32(-127.0), q0),
                                   np.float32(-127.0)), np.float32(127.0))
        t = qc + magic
        d = np.abs(qc - (t - magic))
        sane = 2.0**-100 <= abs(float(s)) <= 2.0**100
        unsure = ~(d < np.float32(0.5 - 2.0**-14)) | ~np.isfinite(q0) | (not sane)
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8), unsure


@pytest.mark.parametrize("scale", [6.0 / 127.0, 2.0**-4, 0.0371, 1e-12 / 127.0, 3.0e5, 1.0])
def test_quantize_shortcut_is_exact_where_sure(scale):
    """Over every finite bf16 value, random float32 values and every
    half-step of the scale: where the shortcut says it is sure it equals
    ``quantize_plain`` (division, round-half-even, clip) bit for bit, and it
    is sure for all but values near a half-step."""
    s = np.float32(scale)
    rng = np.random.default_rng(5)
    bf16 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    steps = (np.arange(-130, 131, dtype=np.float32) + np.float32(0.5)) * s
    v = np.concatenate([bf16[np.isfinite(bf16)], steps, np.nextafter(steps, np.float32(0)),
                        rng.normal(0, 40 * float(s), 200_000).astype(np.float32),
                        np.asarray([0.0, -0.0], np.float32)])
    got, unsure = shortcut(v, s)
    want = quantize.quantize_plain(torch.from_numpy(v)[None], torch.tensor(float(s)))[0].numpy()
    np.testing.assert_array_equal(got[~unsure], want[~unsure])
    assert not unsure[-2:].any()  # zeros are sure: no division for them
    assert unsure[-200_002:-2].mean() < 1e-3  # the random values
    if 2.0**-100 <= scale <= 2.0**100:
        assert unsure[np.abs(v) < 1e6 * s].mean() < 0.01


def test_quantize_shortcut_defers_on_odd_scales_and_values():
    for s in (0.0, np.inf, np.nan, 1e-38, 1e38):
        assert shortcut(np.asarray([1.0, 0.0], np.float32), np.float32(s))[1].all()
    _, unsure = shortcut(np.asarray([np.nan, np.inf, -np.inf, 1.0], np.float32), np.float32(0.05))
    assert unsure.tolist() == [True, True, True, False]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("relu", [False, True])
def test_quantize_zeros_match_jax(dtype, relu):
    """``0.0``, ``-0.0`` and a tensor that is half zeros (a ReLU output)
    quantize as the JAX package's reference does, bit for bit."""
    rng = np.random.default_rng(17)
    x = rng.normal(0, 2.0, (2, 6, 5, 16)).astype(np.float32)
    x[x < 0] = 0.0
    x.reshape(-1)[::7] = -0.0
    x.reshape(-1)[:2] = [0.0, -0.0]
    assert (x == 0).mean() > 0.5 and np.signbit(x).any()
    sx = np.asarray([5.0 / 127.0, 7.5 / 127.0], np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jquantize.quantize_reference(jx, jnp.asarray(sx), relu=relu))
    got = quantize.quantize_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(sx), relu).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[x == 0].any()
    s8, unsure = shortcut(np.asarray(jx.astype(jnp.float32))[0], sx[0])
    assert not unsure[x[0] == 0].any() and not s8[x[0] == 0].any()
