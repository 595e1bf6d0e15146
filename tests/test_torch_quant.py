"""Port parity for the int8 serving path: bmcnet_esr_torch's quantize_act,
quant_matmul and quant_conv3x3 (their plain versions, which the CPU runs),
QuantConv in every quant mode, calibration and the int8 rollouts, against
the JAX package (Pallas kernels in interpret mode) on seeded numpy inputs.

Tolerances:

* int8 outputs and int32 accumulators: exact;
* float outputs of the int8 epilogue, ``acc * (sx * sw) + bias``: XLA may
  contract the product and sum into one fused multiply-add where the port
  rounds twice, so float32 outputs agree to rtol 1e-6, and bf16 outputs to
  one bf16 ulp (rtol 1e-2, as tests/test_pallas.py) on at most 1 % of the
  elements;
* calibrated scales and rollouts: the float parts of the two models (bf16
  norms, attention, 1x1 convs) round differently, and a rounding that
  crosses a quantization step moves an int8 value by one; the bounds below
  are stated per test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.models import BMCNet as JBMCNet
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain
from bmcnet_esr_tpu.models import calibrate_act_scales as jcalibrate
from bmcnet_esr_tpu.models.layers import QuantConv as JQuantConv
from bmcnet_esr_tpu.ops.pallas import qconv as jqconv
from bmcnet_esr_tpu.ops.pallas import qmm as jqmm
from bmcnet_esr_tpu.ops.pallas import quantize as jquantize

from bmcnet_esr_torch.data import DatasetConfig
from bmcnet_esr_torch.inference import InferenceEngine, load_model_for_inference
from bmcnet_esr_torch.inference.engine import INT8_DTYPES
from bmcnet_esr_torch.kernels import qconv, qmm, quantize
from bmcnet_esr_torch.models import (
    BMCNet,
    BMCNetPlain,
    QuantConv,
    act_scales,
    act_scales_from_jax,
    calibrate_act_scales,
    load_checkpoint,
    params_from_jax,
    quant_convs,
    set_act_scales,
)
from bmcnet_esr_torch.ops.batch import compact_events

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: torch's default
    of one thread per core oversubscribes the CPU, so these tests use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def assert_bf16_close(got, want):
    """One bf16 ulp on at most 1 % of the elements (FMA contraction in XLA)."""
    got, want = np32(got), np32(want)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert (got == want).mean() > 0.99, (got != want).sum()


def lane_scales(rng, b):
    return (rng.uniform(3.0, 9.0, b) / 127.0).astype(np.float32)


# -- kernels -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scale", ["scalar", "one", "lanes"])
@pytest.mark.parametrize("relu", [False, True])
def test_quantize_act_matches_jax(dtype, scale, relu):
    """Exact: random values plus every half-step (k + 1/2) * sx (ties round
    to even) and values past +-127 steps (clipped)."""
    rng = np.random.default_rng(13)
    b, h, w, c = 3, 5, 7, 9
    sx = {"scalar": np.float32(2.0**-4), "one": np.asarray([2.0**-4], np.float32),
          "lanes": np.asarray([2.0**-4, 2.0**-3, 2.0**-5], np.float32)}[scale]
    x = rng.normal(0, 4.0, (b, h, w, c)).astype(np.float32)
    x.reshape(-1)[:256] = (np.arange(-128, 128) + 0.5) * 2.0**-5  # half-steps of the smallest scale
    x.reshape(-1)[256:260] = [300.0, -300.0, 8.0, -8.0]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jquantize.quantize_reference(jx, jnp.asarray(sx), relu=relu))
    kern = np.asarray(jquantize.quantize_act(jx, jnp.asarray(sx), relu=relu, interpret=True))
    got = quantize.quantize_act(t(x, getattr(torch, dtype)), torch.as_tensor(sx), relu).numpy()
    np.testing.assert_array_equal(kern, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8


def test_quantize_act_rejects_wrong_lane_count():
    with pytest.raises(ValueError, match="3 scales for 2 lanes"):
        quantize.quantize_act(torch.zeros(2, 3, 3, 4), torch.ones(3))


def test_quantize_weights_match_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.1, (131, 24)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output channel: scale floored at 1e-12 / 127
    wq, sw = qmm.quantize_weights(t(w))
    jwq, jsw = jqmm.quantize_weights(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    w3 = rng.normal(0, 0.1, (3, 3, 131, 32)).astype(np.float32)
    wq3, sw3 = qconv.quantize_weights3x3(t(w3))
    jwq3, jsw3 = jqconv.quantize_weights3x3(jnp.asarray(w3))
    np.testing.assert_array_equal(wq3.numpy(), np.asarray(jwq3))
    np.testing.assert_array_equal(sw3.numpy(), np.asarray(jsw3))


@pytest.mark.parametrize("m,k,n", [(576, 128, 128), (100, 131, 24)])
def test_quant_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(7)
    b = 2
    x = jnp.asarray(rng.normal(0, 2.0, (b, m, k)).astype(np.float32)).astype(jnp.bfloat16)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    bias = rng.normal(0, 0.5, n).astype(np.float32)
    sx = lane_scales(rng, b)
    jwq, jsw = jqmm.quantize_weights(jnp.asarray(w))
    wq, sw = qmm.quantize_weights(t(w))
    xt = t(np.array(x.astype(jnp.float32)), torch.bfloat16)
    # int32 accumulators exact
    xq = quantize.quantize_plain(xt, t(sx))
    jacc = jnp.einsum("bmk,kn->bmn", jnp.asarray(xq.numpy()), jwq, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(qmm.qmm_acc_plain(xq, wq).numpy(), np.asarray(jacc))
    want = jqmm.qmm_reference(x, jwq, jsw, jnp.asarray(sx), jnp.asarray(bias))
    kern = jqmm.quant_matmul(x, jwq, jsw, jnp.asarray(sx), jnp.asarray(bias), interpret=True)
    got = qmm.quant_matmul(xt, wq, sw, t(sx), t(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (b, m, n)
    assert_bf16_close(got, want)
    assert_bf16_close(got, kern)
    # the int8-input form computes the same function
    assert torch.equal(qmm.quant_matmul(xq, wq, sw, t(sx), t(bias)), got)
    # a 2-D x is one lane
    assert torch.equal(qmm.quant_matmul(xt[1], wq, sw, t(sx[1:]), t(bias)), got[1])


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 12, 16, 8, 16),
    (1, 9, 11, 131, 8),   # odd channel count, W not a multiple of 8
    (3, 7, 13, 16, 32),   # odd spatial dims
])
def test_quant_conv3x3_matches_jax(b, h, w, cin, cout):
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(0, 2.0, (b, h, w, cin)).astype(np.float32)).astype(jnp.bfloat16)
    wf = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    sx = lane_scales(rng, b)
    jwq, jsw = jqconv.quantize_weights3x3(jnp.asarray(wf))
    wq, sw = qconv.quantize_weights3x3(t(wf))
    xt = t(np.array(x.astype(jnp.float32)), torch.bfloat16)
    xq = quantize.quantize_plain(xt, t(sx))
    jacc = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jwq, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(qconv.conv3x3_acc_plain(xq, wq).numpy(), np.asarray(jacc))
    want = jqconv.qconv3x3_reference(x, jwq, jsw, jnp.asarray(sx), jnp.asarray(bias))
    kern = jqconv.quant_conv3x3(x, jwq, jsw, jnp.asarray(sx), jnp.asarray(bias), interpret=True)
    got = qconv.quant_conv3x3(xt, wq, sw, t(sx), t(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    assert_bf16_close(got, want)
    assert_bf16_close(got, kern)
    assert torch.equal(qconv.quant_conv3x3(xq, wq, sw, t(sx), t(bias)), got)


def test_quant_conv3x3_zero_padding_matches_same_conv():
    """Border taps are zero, as SAME padding of the quantized input (the
    JAX package's TestQuantConv3x3 case, float32 out, rtol 1e-6)."""
    rng = np.random.default_rng(5)
    b, h, w, c = 1, 6, 7, 8
    x = rng.normal(0, 1.0, (b, h, w, c)).astype(np.float32)
    wf = rng.normal(0, 0.2, (3, 3, c, c)).astype(np.float32)
    bias = np.zeros(c, np.float32)
    sx = np.float32(4.0 / 127.0)
    jwq, jsw = jqconv.quantize_weights3x3(jnp.asarray(wf))
    want = np.asarray(jqconv.qconv3x3_reference(jnp.asarray(x), jwq, jsw, sx, jnp.asarray(bias),
                                                out_dtype=jnp.float32))
    wq, sw = qconv.quantize_weights3x3(t(wf))
    got = qconv.quant_conv3x3(t(x), wq, sw, torch.tensor(sx), t(bias),
                              out_dtype=torch.float32).numpy()
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1], np.s_[:]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-6, atol=1e-6)


def test_quant_conv3x3_emit_is_relu_then_quantize():
    """The int8 epilogue equals the float output, ReLU, then quantize at the
    emit scale: exact, since both sides share the float32 epilogue."""
    rng = np.random.default_rng(8)
    x = t(rng.normal(0, 1.5, (2, 5, 6, 12)))
    wq, sw = qconv.quantize_weights3x3(t(rng.normal(0, 0.2, (3, 3, 12, 10))))
    bias, sx, se = t(rng.normal(0, 0.3, 10)), t(lane_scales(rng, 2)), t(lane_scales(rng, 2))
    y = qconv.quant_conv3x3(x, wq, sw, sx, bias, out_dtype=torch.float32)
    want = quantize.quantize_plain(y, se, relu=True)
    got = qconv.quant_conv3x3(x, wq, sw, sx, bias, emit_scale=se, emit_relu=True)
    assert got.dtype == torch.int8 and torch.equal(got, want)


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device than the
    CPU and CUDA is refused."""
    x = torch.zeros((1, 3, 3, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        quantize.quantize_act(x, 1.0)
    wq, sw = qconv.quantize_weights3x3(torch.zeros(3, 3, 8, 4, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        qconv.quant_conv3x3(x, wq, sw, 1.0, torch.zeros(4, device="meta"))


# -- QuantConv -----------------------------------------------------------------


def _jquantconv(kernel, mode, dtype):
    """The JAX package's QuantConv with the flags its ``_conv`` derives
    from ``mode``."""
    return JQuantConv(
        features=6, kernel=kernel, dtype=dtype,
        pallas_1x1=mode in ("p1x1", "pall") and kernel == 1,
        pallas_3x3=mode in ("pconv", "pall") and kernel == 3,
        pallas_quant=mode in ("pquant", "chainq"),
    )


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("mode,kernel", [
    ("xla", 3), ("pconv", 3), ("pall", 3), ("pquant", 3), ("chain", 3),
    ("chainq", 3), ("p1x1", 1), ("pall", 1),
])
def test_quantconv_matches_jax(mode, kernel, static):
    """float32 compute: outputs within rtol 1e-6 (the epilogue's FMA), on
    dynamic per-lane scales and on static scales; 8x8 images, so the JAX
    package takes its Pallas routes (interpret mode) where the mode asks."""
    rng = np.random.default_rng(17)
    b, h, w, cin = 2, 8, 8, 5
    x = rng.normal(0, 1.5, (b, h, w, cin)).astype(np.float32)
    x[1] *= 10.0  # lanes of different magnitude
    jm = _jquantconv(kernel, mode, jnp.float32)
    v = dict(jm.init(jax.random.key(1), jnp.asarray(x)))
    v["params"] = {"kernel": jnp.asarray(rng.normal(0, 0.2, (kernel, kernel, cin, 6)), jnp.float32),
                   "bias": jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)}
    sx = lane_scales(rng, b) * np.asarray([1.0, 10.0], np.float32)
    if static:
        v["quant"] = {"act_scale": jnp.asarray(sx).reshape(b, 1, 1, 1)}
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = QuantConv(cin, 6, kernel, torch.float32, mode)
    m.load_state_dict(params_from_jax({"params": v["params"]}))
    if static:
        m.act_scale = t(sx)
    got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["chain", "chainq"])
def test_quantconv_emit_and_in_scale_match_jax(mode):
    """The chain modes' hand-off: ``emit_scale`` returns int8 (exact
    against JAX), and ``in_scale`` convolves that int8 tensor (rtol 1e-6)."""
    rng = np.random.default_rng(9)
    b, h, w, c = 2, 7, 9, 8
    x = rng.normal(0, 1.5, (b, h, w, c)).astype(np.float32)
    jm = JQuantConv(features=c, kernel=3, dtype=jnp.float32, pallas_quant=mode == "chainq")
    v = dict(jm.init(jax.random.key(1), jnp.asarray(x)))
    s_in, s_emit = lane_scales(rng, b), lane_scales(rng, b)
    v["quant"] = {"act_scale": jnp.asarray(s_in).reshape(b, 1, 1, 1)}
    jq = np.asarray(jm.apply(v, jnp.asarray(x), emit_scale=jnp.asarray(s_emit), emit_relu=True))
    jy = np.asarray(jm.apply(v, jnp.asarray(jq), in_scale=jnp.asarray(s_emit)))
    m = QuantConv(c, c, 3, torch.float32, mode)
    m.load_state_dict(params_from_jax({"params": v["params"]}))
    m.act_scale = t(s_in)
    q = m(t(x).permute(0, 3, 1, 2), emit_scale=t(s_emit), emit_relu=True)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), jq)
    y = m(q, in_scale=t(s_emit)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)


def test_quantconv_qat_matches_jax():
    """Fake-quant forward (float32) within rtol 1e-5 of the JAX package's,
    and straight-through: the input gradient is the float conv's."""
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1.0, (2, 6, 7, 4)).astype(np.float32)
    jm = JQuantConv(features=5, kernel=3, dtype=jnp.float32, qat=True)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda a: jm.apply(v, a).sum())(jnp.asarray(x)))
    m = QuantConv(4, 5, 3, torch.float32, "qat")
    m.load_state_dict(params_from_jax(v))
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), want, rtol=1e-5, atol=1e-5)
    y.sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jgrad, rtol=1e-5, atol=1e-5)
    assert m.weight.grad is not None and torch.isfinite(m.weight.grad).all()


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="unknown quant mode"):
        BMCNetPlain(scale=2, n_c=8, n_b=1, quant="int4")


def test_quant_state_dict_identical_to_float():
    """No new checkpoint format: the same keys, shapes and dtypes, and the
    static scales are not in the state dict."""
    f = BMCNet(scale=2, n_c=8, n_b=1).state_dict()
    q = BMCNet(scale=2, n_c=8, n_b=1, dtype=torch.bfloat16, quant="chainq")
    set_act_scales(q, {"neuro.conv_o": torch.ones(1)})
    sd = q.state_dict()
    assert [(k, v.shape, v.dtype) for k, v in f.items()] == [(k, v.shape, v.dtype) for k, v in sd.items()]


def test_weight_cache_follows_load_state_dict():
    """Quantized weights are cached, and a new state dict must not leave a
    stale copy behind."""
    rng = np.random.default_rng(3)
    m = QuantConv(4, 4, 3, torch.float32, "xla")
    x = t(rng.normal(0, 1, (1, 4, 5, 5)))
    y0 = m(x)
    assert torch.equal(m(x), y0)  # cached
    sd = {k: v * 2 + 0.1 for k, v in m.state_dict().items()}
    m.load_state_dict(sd)
    fresh = QuantConv(4, 4, 3, torch.float32, "xla")
    fresh.load_state_dict(sd)
    assert torch.equal(m(x), fresh(x)) and not torch.equal(m(x), y0)


# -- models, calibration, rollouts ---------------------------------------------

H = W = 8  # a multiple of 8: the JAX package's fused 3x3 route accepts it


def _pairs(seed, steps, b=1):
    return np.random.default_rng(seed).poisson(0.7, (steps, b, 2, H, W, 2)).astype(np.float32)


def redrawn(variables, seed):
    """flax variables with every leaf redrawn as numpy (convs kaiming-normal,
    biases small, norm scales around 1), so activations are far from zero."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + rng.normal(0, 0.2, a.shape)).astype(np.float32)
        if a.ndim == 4:
            return rng.normal(0, np.sqrt(1.0 / np.prod(a.shape[:-1])), a.shape).astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def plain_small():
    m = JBMCNetPlain(scale=2, n_c=8, n_b=2)
    return redrawn(m.init(jax.random.key(0), jnp.zeros((1, 2, H, W, 2)), *m.init_state(1, H, W)), 5)


def _jrollout(model, v, x):
    carry = tuple(model.init_state(x.shape[1], H, W))
    preds = []
    for xi in x:
        carry = tuple(model.apply(v, jnp.asarray(xi), *carry))
        preds.append(np.asarray(carry[-1], np.float32))
    return np.stack(preds)


def _rollout(model, x):
    with torch.inference_mode():
        carry = model.init_state(x.shape[1], H, W)
        preds = []
        for xi in x:
            carry = model(t(xi), *carry)
            preds.append(carry[-1].float().numpy())
    return np.stack(preds)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("percentile", [None, 0.995, 0.999, 0.9999])
def test_calibration_matches_jax(plain_small, percentile):
    """Static scales from 3 calibration steps, float32 compute: every
    module, every lane, within rtol 1e-6 of the JAX package's (the
    recorded maxima and quantiles come from activations that agree to
    float32 summation order; measured 3.6e-7)."""
    x = _pairs(1, 3, b=2)
    jm = JBMCNetPlain(scale=2, n_c=8, n_b=2, quant=True)
    jv = jcalibrate(jm, plain_small, jnp.asarray(x), tuple(jm.init_state(2, H, W)),
                    max_steps=3, percentile=percentile)
    want = act_scales_from_jax(jv)
    m = BMCNetPlain(scale=2, n_c=8, n_b=2, quant=True)
    m.load_state_dict(params_from_jax(plain_small))
    got = calibrate_act_scales(m, t(x), m.init_state(2, H, W), max_steps=3,
                               percentile=percentile)
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k].shape == (2,)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
    assert act_scales(m).keys() == got.keys()


def test_calibration_rejects_unknown_percentile():
    with pytest.raises(ValueError, match="percentile"):
        calibrate_act_scales(BMCNetPlain(scale=2, n_c=8, n_b=1, quant=True), None, (),
                             percentile=0.5)


@pytest.mark.parametrize("dtype", list(INT8_DTYPES))
def test_int8_rollout_matches_jax(plain_small, dtype):
    """Both packages on the same static scales (JAX calibrates, the port
    takes the scales over), bf16 compute, 4 recurrent steps: rel-RMSE below
    2e-2 against the JAX rollout (measured 0 to 4.9e-3), and both within the
    int8 serving bound of 5e-2 of the float32 rollout."""
    mode = INT8_DTYPES[dtype]
    x = _pairs(2, 4)
    jm = JBMCNetPlain(scale=2, n_c=8, n_b=2, dtype=jnp.bfloat16, quant=mode)
    jv = jcalibrate(jm, plain_small, jnp.asarray(x), tuple(jm.init_state(1, H, W)), max_steps=2)
    want = _jrollout(jm, jv, x)
    m = BMCNetPlain(scale=2, n_c=8, n_b=2, dtype=torch.bfloat16, quant=mode)
    m.load_state_dict(params_from_jax(plain_small))
    set_act_scales(m, act_scales_from_jax(jv))
    got = _rollout(m, x)
    f32 = BMCNetPlain(scale=2, n_c=8, n_b=2)
    f32.load_state_dict(params_from_jax(plain_small))
    ref = _rollout(f32, x)
    assert np.all(np.isfinite(got))
    assert _rel_rmse(got, want) < 2e-2, _rel_rmse(got, want)
    assert _rel_rmse(got, ref) < 5e-2 and _rel_rmse(want, ref) < 5e-2


def test_full_model_int8_matches_jax():
    """The full BMCNet in the default int8 dtype, dynamic scales, 2 steps:
    rel-RMSE below 2e-2 against the JAX rollout."""
    x = _pairs(3, 2)
    jm = JBMCNet(scale=2, n_c=8, n_b=1, dtype=jnp.bfloat16, quant=True)
    jf = JBMCNet(scale=2, n_c=8, n_b=1)
    v = redrawn(jf.init(jax.random.key(0), jnp.asarray(x[0]), *jf.init_state(1, H, W)), 6)
    want = _jrollout(jm, v, x)
    m = BMCNet(scale=2, n_c=8, n_b=1, dtype=torch.bfloat16, quant=True)
    m.load_state_dict(params_from_jax(v))
    got = _rollout(m, x)
    assert _rel_rmse(got, want) < 2e-2, _rel_rmse(got, want)


@pytest.mark.parametrize("dtype", ["int8", "int8_chainq"])
def test_released_checkpoint_int8_close_to_fp32(dtype):
    """The released checkpoint (n_c=128, n_b=5, x4) on its golden windows:
    int8 on dynamic scales, int8_chainq on scales calibrated over the same
    windows; rel-RMSE against float32 below the serving bound 5e-2."""
    path = os.path.join(GOLDENS, "plain_nfs_x4_ckpt.npz")
    with np.load(path) as z:
        x = np.transpose(z["x"], (0, 1, 3, 4, 5, 2))
    sd = load_checkpoint(path)
    f32 = BMCNetPlain(scale=4)
    f32.load_state_dict(sd)
    q = BMCNetPlain(scale=4, dtype=torch.bfloat16, quant=INT8_DTYPES[dtype])
    q.load_state_dict(sd)

    def roll(model):
        with torch.inference_mode():
            st = model.init_state(x.shape[1], x.shape[3], x.shape[4])
            if model.quant and dtype != "int8":
                calibrate_act_scales(model, t(x), st)
            out = []
            for xi in x:
                st = model(t(xi), *st)
                out.append(st[-1].float().numpy())
        return np.stack(out)

    rel = _rel_rmse(roll(q), roll(f32))
    assert rel < 5e-2, rel


class TestInt8LaneIndependence:
    """Per-lane scales: a batch of streams equals each stream alone, exactly
    (the JAX package's TestInt8LaneIndependence)."""

    def _setup(self, plain_small):
        m = BMCNetPlain(scale=2, n_c=8, n_b=2, dtype=torch.bfloat16, quant=True)
        m.load_state_dict(params_from_jax(plain_small))
        rng = np.random.default_rng(12)
        # two streams of very different magnitude
        x = np.stack([rng.poisson(0.05, (4, 2, H, W, 2)), rng.poisson(5.0, (4, 2, H, W, 2))],
                     axis=1).astype(np.float32)
        return m, x

    def test_dynamic_scales_batched_equals_solo(self, plain_small):
        m, x = self._setup(plain_small)
        batched = _rollout(m, x)
        for lane in range(2):
            np.testing.assert_array_equal(batched[:, lane], _rollout(m, x[:, lane : lane + 1])[:, 0])

    def test_static_per_lane_scales_batched_equals_solo(self, plain_small):
        m, x = self._setup(plain_small)
        with torch.inference_mode():
            cal_b = calibrate_act_scales(m, t(x[:2]), m.init_state(2, H, W))
        batched = _rollout(m, x)
        for lane in range(2):
            with torch.inference_mode():
                cal_s = calibrate_act_scales(m, t(x[:2, lane : lane + 1]), m.init_state(1, H, W))
            for k in cal_b:
                assert torch.equal(cal_b[k][lane : lane + 1], cal_s[k]), k
            np.testing.assert_array_equal(batched[:, lane], _rollout(m, x[:, lane : lane + 1])[:, 0])


# -- entry points --------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(INT8_DTYPES))
def test_load_model_for_inference_int8(dtype):
    model = load_model_for_inference(os.path.join(GOLDENS, "plain_small.npz"), 2, 8, 2,
                                     variant="plain", dtype=dtype, device="cpu")
    assert model.quant == INT8_DTYPES[dtype] and model.dtype == torch.bfloat16
    assert isinstance(model.neuro.conv_o, QuantConv)
    assert isinstance(model.neuro.para_reschunk.v1, QuantConv) == (dtype in ("int8_p1x1",
                                                                             "int8_pall"))


def _windows(seed, n, hw, events):
    h, w = hw
    rng = np.random.default_rng(seed)
    ev = np.zeros((n, 1, 4, events), np.float32)
    ev[:, :, 0] = rng.integers(0, w, (n, 1, events))
    ev[:, :, 1] = rng.integers(0, h, (n, 1, events))
    ev[:, :, 3] = rng.integers(0, 2, (n, 1, events)) * 2 - 1
    return compact_events(ev)


def test_engine_calibrates_and_keeps_callers_scales():
    """The engine installs static scales on its first rollout and derives
    them anew for the next one; scales the caller installed stay as they
    are.  MACs per window equal the bf16 model's."""
    inp = _windows(1, 9, (H, W), 96)
    gt = _windows(2, 8, (2 * H, 2 * W), 384)

    def load_chunk(pos, steps):
        return ((inp[0][pos : pos + steps + 1], inp[1][pos : pos + steps + 1]),
                (gt[0][pos : pos + steps], gt[1][pos : pos + steps]))

    def engine(dtype):
        model = load_model_for_inference(os.path.join(GOLDENS, "plain_small.npz"), 2, 8, 2,
                                         variant="plain", dtype=dtype, device="cpu")
        return InferenceEngine(model, DatasetConfig(scale=2), chunk_size=4, visualize=False,
                               device="cpu")

    bf16 = engine("bfloat16").infer_windows(load_chunk, 8, (H, W), (2 * H, 2 * W))
    eng = engine("int8_pall")
    r = eng.infer_windows(load_chunk, 8, (H, W), (2 * H, 2 * W), return_per_window=True)
    assert r["macs"] == bf16["macs"] and np.all(np.isfinite(r["per_window"]["esr_mse"]))
    first = act_scales(eng.model)
    assert len(first) == len([m for m in eng.model.modules() if isinstance(m, QuantConv)])
    eng.infer_windows(lambda p, s: load_chunk(p + 4, s), 4, (H, W), (2 * H, 2 * W))
    assert any(not torch.equal(first[k], v) for k, v in act_scales(eng.model).items())

    caller = engine("int8")
    mine = {k: torch.full((1,), 0.05) for k in quant_convs(caller.model)}
    set_act_scales(caller.model, mine)
    caller.infer_windows(load_chunk, 8, (H, W), (2 * H, 2 * W))
    assert all(torch.equal(v, mine[k]) for k, v in act_scales(caller.model).items())
