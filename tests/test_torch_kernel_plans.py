"""The host side of the port's CUDA kernels (``bmcnet_esr_torch/csrc``), which
the CPU can check without a GPU: the packed weight layouts of ``qconv.cu``
and ``qmm.cu``, the launch plans of all four kernels, the index arithmetic
the kernels copy (the convolution's halo tile, zero border, per-tap shifted
reads and K split over two warpgroups; the rasterizer's bands of rows built
from every event of a window and stored once; the scalar head, vector body
and scalar tail of the rasterizer and of ``quantize.cu``), the quantization
shortcut the kernels take around the division, and the zero handling, each
walked in numpy and held against the plain version and the JAX package.
Everything here is integer or bit-exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bmcnet_esr_tpu.ops import encodings as jenc
from bmcnet_esr_tpu.ops.pallas import quantize as jquantize
from bmcnet_esr_tpu.ops.pallas.rasterize import pallas_events_to_counts

from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize
from bmcnet_esr_torch.kernels._build import H100_SMS, SMEM_LIMIT
from bmcnet_esr_torch.ops.batch import compact_events

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


# -- the rasterizer: plan, bands, head / body / tail ----------------------------

# (G, N, H, W): the main path's chunks, one training batch (B x L = 2 x 9
# windows), one window, images of one pixel, one row and one column, odd
# sizes, no events, more windows than multiprocessors
RASTER_SHAPES = [(33, 2048, 45, 80), (32, 32768, 180, 320), (18, 2048, 45, 80),
                 (18, 32768, 180, 320), (1, 32768, 180, 320), (1, 15, 45, 80),
                 (2, 512, 1, 1), (5, 2048, 1, 320), (3, 2047, 9, 13), (4, 100, 300, 1),
                 (2, 0, 45, 80), (500, 2048, 45, 80), (7, 4096, 720, 1280), (2, 64, 100, 29056)]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("g,n,h,w", RASTER_SHAPES)
def test_raster_plan_bands_cover_every_row_once(g, n, h, w, compact):
    """Every row of every window lies in exactly one block's band, the band's
    counters fit the card's shared memory, the int32 counters of the compact
    form cannot overflow, and the block has whole warps."""
    plan = rasterize.raster_plan(g, n, h, w, compact)
    assert plan["route"] == "band" and plan["grid"] == g * plan["bands"] < 2**31
    rows, bands = plan["rows"], plan["bands"]
    seen = np.zeros((g, h), np.int64)
    for i in range(plan["grid"]) if plan["grid"] <= 4096 else range(bands):
        win, band = divmod(i, bands)  # as the kernel reads blockIdx.x
        r0 = band * rows
        assert r0 < h  # no empty band
        seen[win, r0 : r0 + min(rows, h - r0)] += 1
    assert (seen[: max(1, min(g, 4096 // bands))] == 1).all()
    assert rows * w * 2 * 4 <= plan["smem_bytes"] <= SMEM_LIMIT and plan["smem_bytes"] % 16 == 0
    assert 32 <= plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert plan["vector"] == (8 if compact else 4)
    if compact:
        assert n * 128 * 128 < 2**31
    if g * -(-h // (SMEM_LIMIT // (w * 8))) <= H100_SMS:  # room on the card: one wave, no more
        assert plan["grid"] <= max(H100_SMS, g)


def test_raster_plan_main_path_fills_the_card_in_one_wave():
    lr = rasterize.raster_plan(33, 2048, 45, 80, True)
    assert (lr["rows"], lr["bands"], lr["grid"]) == (12, 4, 132)
    gt = rasterize.raster_plan(32, 32768, 180, 320, True)
    assert (gt["rows"], gt["bands"], gt["grid"], gt["threads"]) == (45, 4, 128, 1024)
    assert gt["smem_bytes"] == 45 * 320 * 2 * 4 == 115_200
    # fewer multiprocessors, or more windows than multiprocessors: whole images
    assert rasterize.raster_plan(32, 32768, 180, 320, True, sms=40)["bands"] == 2  # 90 rows fit
    assert rasterize.raster_plan(200, 2048, 45, 80, True)["bands"] == 1


def test_raster_plan_training_batch_fills_the_card_in_one_wave():
    """The training path's calls (18 windows each): 7 bands a window, 126
    blocks, one wave on 132 multiprocessors."""
    lr = rasterize.raster_plan(18, 2048, 45, 80, True)
    assert (lr["rows"], lr["bands"], lr["grid"]) == (7, 7, 126)
    gt = rasterize.raster_plan(18, 32768, 180, 320, True)
    assert (gt["rows"], gt["bands"], gt["grid"], gt["threads"]) == (26, 7, 126, 1024)
    assert gt["smem_bytes"] == 26 * 320 * 2 * 4


@pytest.mark.parametrize("g,n,h,w,compact,route", [
    (2, 4096, 2, 30000, True, "event"),    # one row of counters exceeds shared memory
    (2, 4096, 2, 30000, False, "event"),
    (1, 64, 1, 29057, True, "event"),      # by one pixel
    (2, 2**17, 45, 80, True, "event"),     # 2**17 events of p = -128 overflow int32
    (2, 2**17 - 1, 45, 80, True, "band"),
    (2, 2**17, 45, 80, False, "band"),     # the raw form counts in float32
    (2**20, 2**12, 45, 80, True, "band"),  # G x N beyond 2**31
])
def test_raster_plan_takes_the_per_event_kernel_where_it_must(g, n, h, w, compact, route):
    plan = rasterize.raster_plan(g, n, h, w, compact)
    assert plan["route"] == route and (plan["rows"] == 0) == (route == "event")
    if route == "event":
        assert plan["smem_bytes"] == 0 and plan["grid"] == -(-g * n // 256)


def vector_split(addrs, sizes, bounds, n):
    """``csrc``'s ``vector_head``: elements to walk one by one until every
    row (byte address, bytes per element) is on the boundary of its vector
    (``bounds`` bytes), where the last row decides and the others must
    agree; ``n`` when they never do."""
    head = (bounds[-1] - addrs[-1] % bounds[-1]) % bounds[-1] // sizes[-1]
    shared = all((a + head * s) % b == 0 for a, s, b in zip(addrs[:-1], sizes[:-1], bounds[:-1]))
    return min(head, n) if shared else n


def counts_by_bands(xs, ys, ps, hw, plan, addr_x, addr_p, addr_out):
    """The rasterizer as ``csrc/rasterize.cu::band_kernel`` walks it, in
    numpy: per block a cleared band of counters, every event of the block's
    window (scalar head, vectors of ``plan["vector"]`` events dealt to the
    threads in turn, scalar tail), a thread's consecutive events on one cell
    summed before they are added, then the band stored once (scalar lead,
    vectors of four, scalar rest) into an output that starts as NaN.
    ``addr_*`` are the byte addresses of the first window's x row, of its
    polarity row and of the output.  Returns the image and how often each
    output element was written."""
    h, w = hw
    g, n = xs.shape
    size_c, size_p = xs.dtype.itemsize, ps.dtype.itemsize
    compact = ps.dtype == np.int8
    ctype = np.int64 if compact else np.float32
    out = np.full(g * h * w * 2, np.nan, np.float32)
    written = np.zeros(out.shape, np.int64)
    rows, bands, vec, threads = plan["rows"], plan["bands"], plan["vector"], plan["threads"]
    for block in range(plan["grid"]):
        win, band = divmod(block, bands)
        r0 = band * rows
        nrows = min(rows, h - r0)
        cnt = np.zeros(nrows * w * 2, ctype)
        assert cnt.size * 4 <= plan["smem_bytes"]  # the kernel's counters are 4 bytes
        if compact:  # [G, 2, N] int16 and [G, N] int8
            ax = addr_x + win * 2 * n * size_c
            ay, ap = ax + n * size_c, addr_p + win * n
        else:  # [G, 4, N] float32: rows x, y, t, p
            ax = addr_x + win * 4 * n * 4
            ay, ap = ax + n * 4, ax + 3 * n * 4
        head = vector_split((ax, ay, ap), (size_c, size_c, size_p), (16, 16, vec * size_p), n)
        groups = (n - head) // vec
        tail = head + groups * vec
        for t in range(threads):
            mine = [e for i in range(t, groups, threads) for e in range(head + i * vec, head + (i + 1) * vec)]
            mine += [i if i < head else tail + (i - head) for i in range(t, head + n - tail, threads)]
            cell, total = -1, ctype(0)
            for e in mine:
                x, y, p = xs[win, e], ys[win, e], ps[win, e]
                if not (x >= 0 and x < w and y >= 0 and y < h) or p == 0:
                    continue
                row = h - 1 - int(y) - r0
                if row < 0 or row >= nrows:
                    continue
                c = (row * w + int(x)) * 2 + (1 if p < 0 else 0)
                if c != cell:
                    if cell >= 0:
                        cnt[cell] += total
                    cell, total = c, ctype(0)
                total += ctype(p) * ctype(p)
            if cell >= 0:
                cnt[cell] += total
        assert not compact or cnt.max(initial=0) < 2**31
        base = (win * h + r0) * w * 2
        lead = min(cnt.size, (16 - (addr_out + 4 * base) % 16) % 16 // 4)
        vecs = (cnt.size - lead) // 4
        rest = lead + vecs * 4
        for i in range(vecs):
            out[base + lead + 4 * i : base + lead + 4 * i + 4] = cnt[lead + 4 * i : lead + 4 * i + 4]
            written[base + lead + 4 * i : base + lead + 4 * i + 4] += 1
        for c in [*range(lead), *range(rest, cnt.size)]:
            out[base + c] = cnt[c]
            written[base + c] += 1
    return out.reshape(g, h, w, 2), written


def _raster_events(seed, g, n, hw, hot=False):
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((g, 4, n), np.float32)
    ev[:, 0] = rng.integers(-2, w + 2, (g, n))
    ev[:, 1] = rng.integers(-2, h + 2, (g, n))
    ev[:, 3] = rng.integers(-1, 2, (g, n))  # -1, 0 (padding), +1
    if hot:
        ev[:, 0], ev[:, 1] = w // 2, h // 3
    k = min(n, 6)  # the edges of the range test and of truncation toward zero
    ev[0, 0, :k] = [-0.5, w - 0.5, w, 1e5, 0.5, w - 1][:k]
    ev[0, 1, :k] = [0, h - 1, 0, 0, -1e5, h - 0.5][:k]
    return ev


@pytest.mark.parametrize("g,n,hw,off_x,off_p,off_out,hot", [
    (3, 640, (9, 16), 0, 0, 0, False),    # everything on 16-byte boundaries
    (3, 608, (9, 16), 8, 4, 0, False),    # bases 4 events off a boundary: a head of 4
    (3, 604, (9, 16), 0, 0, 0, False),    # N = 4 mod 8: no shared boundary in window 1
    (3, 333, (9, 13), 0, 0, 0, False),    # N odd: no shared boundary past window 0; W odd
    (2, 200, (1, 7), 6, 3, 4, False),     # one row; every base address off the boundary
    (2, 160, (5, 1), 0, 0, 8, False),     # one column
    (2, 512, (6, 8), 0, 0, 0, True),      # every event of a window on one pixel
    (1, 0, (4, 6), 0, 0, 0, False),       # no events: the zeros still have to be written
    (2, 5, (1, 1), 0, 0, 0, False),       # fewer events than one vector, an image of one pixel
    (18, 64, (9, 16), 0, 0, 0, False),    # a training batch's 18 windows: 5 bands a window
])
def test_raster_band_walk_equals_plain_and_jax(g, n, hw, off_x, off_p, off_out, hot):
    """The band kernel's walk, compact and raw, equals ``counts_plain``, the
    JAX scatter (``events_to_channels``) and the Pallas kernel in interpret
    mode, bit for bit, and writes every output element exactly once."""
    ev = _raster_events(n + g, g, n, hw, hot)
    xy, p = compact_events(ev)
    want = rasterize.counts_plain(*(torch.from_numpy(a) for a in (ev[:, 0], ev[:, 1], ev[:, 3])), hw).numpy()
    for sms in (132, 8):  # many bands, then few
        plan = rasterize.raster_plan(g, n, *hw, True, sms=sms)
        got, written = counts_by_bands(xy[:, 0], xy[:, 1], p, hw, plan, 4096 + off_x, 8192 + off_p,
                                       16384 + off_out)
        np.testing.assert_array_equal(got, want)
        assert (written == 1).all()
        plan = rasterize.raster_plan(g, n, *hw, False, sms=sms)
        got, written = counts_by_bands(ev[:, 0], ev[:, 1], ev[:, 3], hw, plan, 4096 + off_x // 4 * 4,
                                       0, 16384 + off_out)
        np.testing.assert_array_equal(got, want)
        assert (written == 1).all()
    np.testing.assert_array_equal(
        rasterize.counts_from_compact(torch.from_numpy(xy), torch.from_numpy(p), hw).numpy(), want)
    jax_scatter = np.stack([np.asarray(jenc.events_to_channels(
        jnp.asarray(e[0]), jnp.asarray(e[1]), jnp.asarray(e[3]), hw)) for e in ev])  # [G, 2, H, W]
    np.testing.assert_array_equal(np.moveaxis(jax_scatter, 1, -1), want)
    if n:
        pallas = np.asarray(pallas_events_to_counts(jnp.asarray(ev), hw, interpret=True))
        np.testing.assert_array_equal(pallas, want)


def test_raster_vector_split():
    """Rows on a common 16-byte boundary after a head; rows that never meet."""
    compact, raw = ((2, 2, 1), (16, 16, 8)), ((4, 4, 4), (16, 16, 16))
    assert vector_split((0, 4096, 8192), *compact, 100) == 0
    assert vector_split((8, 8 + 2 * 608, 4), *compact, 608) == 4       # all three 4 events off
    assert vector_split((0, 2 * 604, 4), *compact, 604) == 604         # only the polarities are
    assert vector_split((0, 2 * 333, 0), *compact, 333) == 333         # y row 2 bytes off
    assert vector_split((6, 6 + 400, 3), *compact, 200) == 5           # all three 5 events off
    assert vector_split((10, 26, 5), *compact, 2) == 2                 # a head longer than N
    assert vector_split((4, 4 + 4 * 64, 4 + 12 * 64), *raw, 64) == 3   # raw rows, base 4 bytes off


# -- quantize_act: plan and head / body / tail ------------------------------------


@pytest.mark.parametrize("lanes,per_lane,grid", [
    (1, 45 * 80 * 128, (450, 1)),   # one unit a thread
    (8, 45 * 80 * 128, (132, 8)),   # 1056 blocks resident at once, a loop inside the block
    (1, 45 * 80 * 416, (1056, 1)),
    (3, 1, (1, 3)), (2, 16 * 256 + 1, (5, 2)), (1000, 4096, (1, 1000)),
])
def test_quantize_plan(lanes, per_lane, grid):
    plan = quantize.quantize_plan(lanes, per_lane)
    assert plan["grid"] == grid and plan["threads"] == 256 and plan["unit"] == 4
    blocks = grid[0]
    assert blocks == 1 or (blocks - 1) * 256 * 4 < per_lane  # no block without a unit
    assert blocks * lanes <= max(H100_SMS * quantize.BLOCKS_PER_SM, lanes)  # one wave
    assert quantize.quantize_plan(lanes, per_lane, sms=1)["grid"][0] <= max(1, 8 // lanes)


def quantize_by_units(x, sx, relu, plan, itemsize, addr_in, addr_out):
    """``csrc/quantize.cu::quantize_kernel`` in numpy on ``x [lanes, n]``
    float32: per lane the scalar head up to the output's first 4-byte
    boundary, units of 4 dealt to the grid's threads in turn (``quantize4``:
    the shortcut, or the division for all 4 when one of them is unsure), and
    the scalar tail (the shortcut or the division per element).  Returns the
    int8 and how often each element was written."""
    lanes, n = x.shape
    out = np.zeros((lanes, n), np.int8)
    written = np.zeros((lanes, n), np.int64)
    stride = plan["grid"][0] * plan["threads"]
    for lane in range(lanes):
        s = np.float32(sx[lane])
        v = np.maximum(x[lane], np.float32(0)) if relu else x[lane]
        with np.errstate(all="ignore"):
            exact = np.where(v == 0, 0, np.clip(np.rint(v / s), -127, 127)).astype(np.int8)
        fast, unsure = shortcut(v, s)
        unit = plan["unit"]
        head = vector_split((addr_in + lane * n * itemsize, addr_out + lane * n), (itemsize, 1),
                            (unit * itemsize, unit), n)
        units = (n - head) // unit
        tail = head + units * unit
        for t in range(min(stride, units)):
            for u in range(t, units, stride):
                grp = slice(head + u * unit, head + (u + 1) * unit)
                out[lane, grp] = exact[grp] if unsure[grp].any() else fast[grp]
                written[lane, grp] += 1
        for e in [*range(head), *range(tail, n)]:
            out[lane, e] = exact[e] if unsure[e] else fast[e]
            written[lane, e] += 1
    return out, written


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,off_in,off_out", [
    ((2, 45, 80, 8), 0, 0),     # whole units only
    ((3, 1, 1, 131), 0, 0),     # odd lanes: heads of 1 and 2, ragged tails
    ((3, 2, 3, 131), 0, 0),
    ((2, 7, 13, 129), 0, 0),
    ((3, 1, 1, 7), 0, 0),       # shorter than one unit
    ((2, 9, 5, 37), 1, 0),      # a view one element in: no shared boundary, all scalar
    ((2, 9, 5, 37), 3, 3),      # input and output off by the same elements: a head of 1
])
def test_quantize_unit_walk_equals_plain_and_jax(dtype, shape, off_in, off_out):
    """The kernel's head / units / tail split writes every element once and
    equals ``quantize_plain``, the JAX package's ``quantize_reference`` and
    its Pallas kernel (interpret mode), with and without the fused ReLU."""
    rng = np.random.default_rng(sum(shape) + off_in)
    x = rng.normal(0, 2.0, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::11] = 0.0
    flat[5::17] = -0.0
    steps = (np.arange(-130, 131) + 0.5) * (6.0 / 127.0)  # half-steps of the first lane's scale
    flat[: min(flat.size // 2, steps.size)] = steps[: min(flat.size // 2, steps.size)]
    sx = rng.uniform(3.0, 9.0, shape[0]).astype(np.float32) / np.float32(127.0)
    sx[0] = np.float32(6.0 / 127.0)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    itemsize = 2 if dtype == "bfloat16" else 4
    xf = tx.float().numpy().reshape(shape[0], -1)
    for relu in (False, True):
        want = quantize.quantize_plain(tx, torch.from_numpy(sx), relu).numpy()
        for sms in (132, 1):
            plan = quantize.quantize_plan(shape[0], xf.shape[1], sms=sms)
            got, written = quantize_by_units(xf, sx, relu, plan, itemsize, 4096 + off_in * itemsize,
                                             8192 + off_out)
            np.testing.assert_array_equal(got.reshape(shape), want)
            assert (written == 1).all()
        np.testing.assert_array_equal(
            np.asarray(jquantize.quantize_reference(jx, jnp.asarray(sx), relu=relu)), want)
        np.testing.assert_array_equal(
            np.asarray(jquantize.quantize_act(jx, jnp.asarray(sx), relu=relu, interpret=True)), want)
