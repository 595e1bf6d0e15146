"""Port parity: bmcnet_esr_torch's layers and models against the flax modules
(weights carried by ``params_from_jax``) and against the reference goldens.

Float32 comparisons on the CPU differ only by summation order; the golden
rollouts use the JAX tests' tolerances (atol 2e-5, rtol 1e-5) and the
released checkpoint its 1e-3 RMSE budget.  bf16 comparisons are bounded as
the JAX package bounds its own bf16 path.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.models import BMCNet as JBMCNet
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain
from bmcnet_esr_tpu.models import layers as jlayers

from bmcnet_esr_torch.models import (
    BIE,
    BMCNet,
    BMCNetPlain,
    ChannelLayerNorm,
    ParallelBlk,
    convert_torch_state_dict,
    count_params,
    load_checkpoint,
    params_from_jax,
)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
NC = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: torch's default
    of one thread per core oversubscribes the CPU and slows small ops by
    orders of magnitude, so these tests use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    """JAX NHWC numpy -> torch NCHW (a channels-last view, as the models use)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def randomized(variables, seed, gain=2.0):
    """flax variables with every leaf redrawn as numpy: conv kernels normal
    with variance ``gain / fan_in``, biases small, norm scales around 1."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        if a.ndim == 4:
            return rng.normal(0, np.sqrt(gain / np.prod(a.shape[:-1])), a.shape).astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def jax_module(cls, x_shapes, seed, **kw):
    m = cls(NC, **kw)
    args = [jnp.zeros(s) for s in x_shapes]
    v = randomized(m.init(jax.random.key(0), *args), seed)
    return m, v


def load(module, variables):
    module.load_state_dict(params_from_jax(variables), strict=True)
    return module.eval()


def inputs(seed, n, shape=(2, 6, 5, NC)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_layernorm_matches_flax(dtype):
    """float32: atol 1e-5.  bf16 (one-pass E[x^2]-E[x]^2 statistics, output
    rounded to bf16): equal up to one bf16 rounding, rtol 1e-2."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(1).normal(5.0, 3.0, (2, 9, 11, NC)).astype(np.float32)
    jm = jlayers.ChannelLayerNorm(NC, dtype=jdt)
    v = randomized(jm.init(jax.random.key(0), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(v, jnp.asarray(x).astype(jdt))).astype(np.float32)
    tm = load(ChannelLayerNorm(NC, dtype=tdt), v)
    got = nhwc(tm(nchw(x).to(tdt)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_bie_and_parallel_blk_match_flax_fp32():
    """Weights from flax through params_from_jax.  Outputs reach ~15, so
    float32 reassociation over 3x3x16-term sums allows atol 5e-5, rtol 1e-5."""
    shp = (2, 6, 5, NC)
    jm, v = jax_module(jlayers.BIE, [shp] * 3, 3)
    xs = inputs(4, 3)
    want = jm.apply(v, *[jnp.asarray(a) for a in xs])
    got = load(BIE(NC), v)(*[nchw(a) for a in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=5e-5, rtol=1e-5)

    jm, v = jax_module(jlayers.ParallelBlk, [shp] * 7, 5)
    xs = inputs(6, 7)
    want = jm.apply(v, *[jnp.asarray(a) for a in xs])
    got = load(ParallelBlk(NC), v)(*[nchw(a) for a in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=5e-5, rtol=1e-5)


def test_bie_bf16_tracks_flax_bf16():
    """bf16 roundings fall at other places in the two frameworks: bounded by
    rel-RMSE 2e-2 against flax's bf16 BIE (the fp32 logits keep the softmax
    itself equal)."""
    shp = (2, 6, 5, NC)
    jm = jlayers.BIE(NC, dtype=jnp.bfloat16)
    v = randomized(jm.init(jax.random.key(0), *[jnp.zeros(shp)] * 3), 7)
    xs = inputs(8, 3)
    want = jm.apply(v, *[jnp.asarray(a).astype(jnp.bfloat16) for a in xs])
    got = load(BIE(NC, dtype=torch.bfloat16), v)(*[nchw(a).bfloat16() for a in xs])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w).astype(np.float32)
        rel = np.sqrt(np.mean((nhwc(g) - w) ** 2)) / max(np.abs(w).max(), 1.0)
        assert rel < 2e-2, rel


# -- whole models --------------------------------------------------------------


def rollout(model, x_seq):
    """x_seq NHWC [S, B, 2, H, W, 2] -> preds [S, ...], first states [S, ...]."""
    st = model.init_state(x_seq.shape[1], x_seq.shape[3], x_seq.shape[4])
    preds, hs = [], []
    with torch.inference_mode():
        for x in x_seq:
            st = model(torch.from_numpy(np.ascontiguousarray(x)), *st)
            preds.append(st[-1].float().numpy())
            hs.append(st[0].float().numpy())
    return np.stack(preds), np.stack(hs)


def golden(name):
    z = np.load(os.path.join(GOLDENS, name))
    g = {k: z[k] for k in z.files if not k.startswith("sd/")}
    g["x"] = np.transpose(g["x"], (0, 1, 3, 4, 5, 2))  # [S, B, C, T, H, W] -> NHWC
    return g


@pytest.mark.parametrize("name,cls", [
    ("plain_small.npz", BMCNetPlain),
    ("full_small.npz", BMCNet),
    ("full_small_x8.npz", BMCNet),
])
def test_small_goldens(name, cls):
    """The JAX package's golden rollouts (tests/test_model_parity.py),
    reference state dicts loaded directly: atol 2e-5, rtol 1e-5."""
    g = golden(name)
    scale, n_c, n_b = (int(v) for v in g["meta"])
    m = cls(scale=scale, n_c=n_c, n_b=n_b)
    m.load_state_dict(load_checkpoint(os.path.join(GOLDENS, name)), strict=True)
    preds, hs = rollout(m, g["x"])
    np.testing.assert_allclose(preds, np.transpose(g["preds"], (0, 1, 3, 4, 2)), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(hs, np.transpose(g["hs"], (0, 1, 3, 4, 2)), atol=2e-5, rtol=1e-5)


def test_released_checkpoint_rollout_and_param_counts():
    g = golden("plain_nfs_x4_ckpt.npz")
    m = BMCNetPlain(scale=4, n_c=128, n_b=5)
    m.load_state_dict(load_checkpoint(os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz")), strict=True)
    assert count_params(m) == 1_003_296
    assert count_params(BMCNet(scale=4, n_c=128, n_b=5)) == 2_731_680
    preds, _ = rollout(m, g["x"])
    want = np.transpose(g["preds"], (0, 1, 3, 4, 2))
    rmse = float(np.sqrt(np.mean((preds - want) ** 2)))
    assert rmse < 1e-3, rmse
    np.testing.assert_allclose(preds, want, atol=5e-4, rtol=1e-4)

    # bf16 serving path: rel-RMSE < 5e-2 against float32, the JAX package's
    # bound (tests/test_model_parity.py::TestBf16Drift)
    m16 = BMCNetPlain(scale=4, n_c=128, n_b=5, dtype=torch.bfloat16)
    m16.load_state_dict(m.state_dict())
    p16, _ = rollout(m16, g["x"])
    rel = float(np.sqrt(np.mean((p16 - preds) ** 2))) / max(float(np.abs(preds).max()), 1.0)
    assert rel < 5e-2, rel


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_models_match_flax_through_params_from_jax(variant):
    """Random flax weights (the models' own init scale) at n_c=8, n_b=2, x2
    carried over: a 3-step rollout agrees with flax at atol 2e-5, rtol 1e-5."""
    jcls, tcls = (JBMCNetPlain, BMCNetPlain) if variant == "plain" else (JBMCNet, BMCNet)
    jm = jcls(scale=2, n_c=NC, n_b=2)
    v = randomized(jm.init(jax.random.key(0), jnp.zeros((1, 2, 6, 5, 2)), *jm.init_state(1, 6, 5)), 9, gain=0.02)
    tm = load(tcls(scale=2, n_c=NC, n_b=2), v)
    x_seq = np.random.default_rng(10).poisson(0.5, (3, 2, 2, 6, 5, 2)).astype(np.float32)
    st = jm.init_state(2, 6, 5)
    apply = jax.jit(jm.apply)
    want = []
    for x in x_seq:
        st = apply(v, jnp.asarray(x), *st)
        want.append(np.asarray(st[-1]))
    preds, _ = rollout(tm, x_seq)
    np.testing.assert_allclose(preds, np.stack(want), atol=2e-5, rtol=1e-5)


# -- checkpoint loading ------------------------------------------------------------


def test_checkpoint_formats_load_the_same_weights(tmp_path):
    """.npz (sd/ layout), .pth and a flattened flax .npz give one state dict."""
    path = os.path.join(GOLDENS, "plain_small.npz")
    sd = load_checkpoint(path)
    z = np.load(path)
    ref_sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd/")}
    torch.save(ref_sd, tmp_path / "ckpt.pth")
    from_pth = load_checkpoint(str(tmp_path / "ckpt.pth"))
    assert sorted(from_pth) == sorted(sd)
    assert all(torch.equal(from_pth[k], sd[k]) for k in sd)

    from bmcnet_esr_tpu.models import convert_torch_state_dict as jconvert

    variables = jconvert({k: v.numpy() for k, v in ref_sd.items()})  # cli.convert --npz layout
    flat = {
        "/".join(str(k.key) for k in p): np.asarray(a)
        for p, a in jax.tree_util.tree_leaves_with_path(variables)
    }
    np.savez(tmp_path / "flat.npz", **flat)
    from_flax = load_checkpoint(str(tmp_path / "flat.npz"))
    assert sorted(from_flax) == sorted(sd)
    assert all(torch.equal(from_flax[k], sd[k]) for k in sd)


def test_tied_alias_mismatch_is_rejected():
    z = np.load(os.path.join(GOLDENS, "plain_small.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    sd["neuro.conv_f2.weight"] = sd["neuro.conv_f2.weight"] + 1.0  # alias of conv_f1
    with pytest.raises(ValueError, match="tied alias mismatch"):
        convert_torch_state_dict(sd)


def test_unported_options_name_their_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        load_checkpoint(str(tmp_path))  # an Orbax train-state directory
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        BMCNetPlain(scale=2, n_c=NC, n_b=1, quant="pconv")
    with pytest.raises(ValueError, match="bfloat16"):
        BMCNet(scale=2, n_c=NC, n_b=1, dtype=torch.float16)


def test_generator_init_is_reproducible():
    a = BMCNetPlain(scale=2, n_c=NC, n_b=1, generator=torch.Generator().manual_seed(3))
    b = BMCNetPlain(scale=2, n_c=NC, n_b=1, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    w = a.neuro.conv_h.weight
    assert 0.5 < float(w.detach().std()) / np.sqrt(0.02 / (NC * 9)) < 1.5  # kaiming-normal x 0.1
