"""Port parity for serving bundles: bmcnet_esr_torch's kernel operators
(``torch.ops.bmcnet.*``), ``export_serving_bundle``, ``ExportedStream`` and
``cli.export`` on the CPU at a tiny size (n_c=8, n_b=2, x2, 12x10 LR,
windows of 96 events), against the port's ``StreamingSR`` and the JAX
package.

Tolerances:

* a bundle against the port's ``StreamingSR`` in the same dtype (float32,
  dynamic int8, static int8 in three modes): bit for bit, since the program
  runs the same operators on the same inputs;
* a float32 bundle against the JAX ``StreamingSR`` on the same weights:
  ``PRED_TOL`` (rtol 1e-5, atol 1e-6), the bound of
  ``tests/test_torch_streaming.py`` (the two frameworks' float32
  convolutions differ by summation order); the JAX tests pin the JAX
  ``ExportedStream`` to the JAX ``StreamingSR`` bit for bit;
* the meta keys the two bundles share: equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.library import opcheck

import jax
import jax.numpy as jnp

from bmcnet_esr_tpu.inference import export as jexport
from bmcnet_esr_tpu.inference import streaming as jstreaming
from bmcnet_esr_tpu.models import BMCNet as JBMCNet
from bmcnet_esr_tpu.models import BMCNetPlain as JBMCNetPlain

from bmcnet_esr_torch.cli.export import main as export_main
from bmcnet_esr_torch.data import write_synthetic_fixture
from bmcnet_esr_torch.inference import (
    ExportedStream,
    StreamingSR,
    export_serving_bundle,
    load_model_for_inference,
)
from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize
from bmcnet_esr_torch.models import (
    BMCNet,
    BMCNetPlain,
    act_scales,
    calibrate_act_scales,
    params_from_jax,
    quant_convs,
)
from bmcnet_esr_torch.models.quant import frozen_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "plain_small.npz")
RES = (12, 10)
WINDOW = 96
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
SHARED_META = ("inp_resolution", "window_size", "batch", "carry_shapes", "carry_dtypes", "scale",
               "n_c", "n_b", "variant", "quant", "quant_mode", "quant_static")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: torch's default
    of one thread per core oversubscribes the CPU, so these tests use two."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_windows(n, batch=None, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = (4, WINDOW) if batch is None else (batch, 4, WINDOW)
        ev = np.zeros(shape, np.float32)
        ev[..., 0, :] = rng.integers(0, RES[1], shape[:-2] + (WINDOW,))
        ev[..., 1, :] = rng.integers(0, RES[0], shape[:-2] + (WINDOW,))
        ev[..., 2, :] = np.sort(rng.random(shape[:-2] + (WINDOW,)), axis=-1)
        ev[..., 3, :] = rng.integers(0, 2, shape[:-2] + (WINDOW,)) * 2 - 1
        out.append(ev)
    return out


def _jax_model(jcls, **kw):
    m = jcls(scale=2, n_c=8, n_b=2, **kw)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, *RES, 2)), *m.init_state(1, *RES))
    return m, v


def _port(sd, cls=BMCNetPlain, **kw):
    m = cls(scale=2, n_c=8, n_b=2, **kw)
    m.load_state_dict(sd)
    return m


def _pairs(seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.poisson(0.7, (3, 1, 2, *RES, 2)).astype(np.float32))


def _calibrated(sd, quant):
    m = _port(sd, dtype=torch.bfloat16, quant=quant)
    calibrate_act_scales(m, _pairs(), m.init_state(1, *RES))
    return m


@pytest.fixture(scope="module")
def jax_models():
    return {"plain": _jax_model(JBMCNetPlain), "full": _jax_model(JBMCNet)}


@pytest.fixture(scope="module")
def float_bundles(jax_models, tmp_path_factory):
    """A float32 batch-1 bundle of each variant, on the JAX models' weights."""
    out = {}
    for variant, cls in (("plain", BMCNetPlain), ("full", BMCNet)):
        sd = params_from_jax(jax_models[variant][1])
        path = str(tmp_path_factory.mktemp("bundles") / variant)
        # a fresh model takes the weights as a serving state, as StreamingSR does
        export_serving_bundle(cls(scale=2, n_c=8, n_b=2), {"params": sd}, path, RES, WINDOW,
                              device="cpu")
        out[variant] = (path, sd, cls)
    return out


def _assert_streams_equal(live, served, windows, exact=True):
    for i, ev in enumerate(windows):
        want, got = live.push(ev), served.push(ev)
        if want is None:
            assert got is None, f"window {i}"
            continue
        want = np.asarray(want, np.float32)
        assert got.dtype == np.float32 and got.shape == (1, *want.shape)
        if exact:
            np.testing.assert_array_equal(got[0], want, err_msg=f"window {i}")
        else:
            np.testing.assert_allclose(got[0], want, err_msg=f"window {i}", **PRED_TOL)
    assert served.windows_seen == live.windows_seen == len(windows)


# -- the operators ------------------------------------------------------------------


def _opcheck_cases():
    rng = np.random.default_rng(0)
    ev = np.zeros((2, 4, 40), np.float32)
    ev[:, 0] = rng.integers(-2, 9, (2, 40))
    ev[:, 1] = rng.integers(-2, 7, (2, 40))
    ev[:, 3] = rng.integers(-1, 2, (2, 40))
    xy = torch.from_numpy(ev[:, :2].astype(np.int16))
    p = torch.from_numpy(ev[:, 3].astype(np.int8))
    events = torch.from_numpy(ev)
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 16)).astype(np.float32))
    sx = torch.tensor([0.02, 0.03])
    w3, w1 = rng.normal(0, 0.1, (3, 3, 16, 8)), rng.normal(0, 0.1, (16, 8))
    wq3, sw3 = qconv.quantize_weights3x3(torch.from_numpy(w3.astype(np.float32)))
    wq1, sw1 = qmm.quantize_weights(torch.from_numpy(w1.astype(np.float32)))
    bias = torch.from_numpy(rng.normal(0, 0.1, 8).astype(np.float32))
    xq = quantize.quantize_plain(x, sx)
    ops = torch.ops.bmcnet
    return {
        "rasterize_compact": (ops.rasterize_counts_compact.default, (xy, p, 7, 9)),
        "rasterize_compact_into": (ops.rasterize_counts_compact.into,
                                   (xy, p, 7, 9, torch.full((2, 7, 9, 2), float("nan")))),
        "rasterize_f32": (ops.rasterize_counts_f32.default, (events, 7, 9)),
        "rasterize_f32_into": (ops.rasterize_counts_f32.into,
                               (events, 7, 9, torch.full((2, 7, 9, 2), float("nan")))),
        "quantize_act": (ops.quantize_act.default, (x.bfloat16(), sx, True)),
        "quant_matmul_int8": (ops.quant_matmul.default,
                              (xq.view(2, 30, 16), wq1, sw1, sx, bias, torch.float32, None)),
        "quant_matmul_fused": (ops.quant_matmul.default,
                               (x.view(2, 30, 16).bfloat16(), wq1, sw1, sx, bias, torch.bfloat16,
                                None)),
        "quant_conv3x3_int8": (ops.quant_conv3x3.default,
                               (xq, wq3, sw3, sx, bias, torch.bfloat16, None, False, None)),
        "quant_conv3x3_emit": (ops.quant_conv3x3.default,
                               (x, wq3, sw3, sx, bias, torch.float32, torch.tensor([0.5, 0.25]),
                                True, None)),
    }


OPCHECK_CASES = ("rasterize_compact", "rasterize_compact_into", "rasterize_f32",
                 "rasterize_f32_into", "quantize_act", "quant_matmul_int8", "quant_matmul_fused",
                 "quant_conv3x3_int8", "quant_conv3x3_emit")


@pytest.mark.parametrize("case", OPCHECK_CASES)
def test_opcheck(case):
    """Each operator's schema, fake implementation (shape, dtype and strides
    of the CPU result) and registrations pass ``torch.library.opcheck``."""
    op, args = _opcheck_cases()[case]
    opcheck(op, args)


def test_wrappers_call_the_operators_and_keep_their_results():
    """The public wrappers are the operators plus argument normalization: a
    scalar scale goes per lane, the into form fills every element."""
    cases = _opcheck_cases()
    _, (xy, p, h, w) = cases["rasterize_compact"]
    want = rasterize.counts_plain(xy[:, 0], xy[:, 1], p, (h, w))
    assert torch.equal(rasterize.counts_from_compact(xy, p, (h, w)), want)
    into = torch.full((2, h, w, 2), float("nan"))
    assert rasterize.counts_from_compact(xy, p, (h, w), out=into) is into
    assert torch.equal(into, want)
    _, (x, sx, relu) = cases["quantize_act"]
    assert torch.equal(quantize.quantize_act(x, 0.02, relu),
                       torch.ops.bmcnet.quantize_act(x, torch.tensor([0.02, 0.02]), relu))
    _, (xq, wq, sw, s, bias, dt, emit, emit_relu, packed) = cases["quant_conv3x3_int8"]
    got = qconv.quant_conv3x3(xq, wq, sw, s, bias, out_dtype=dt)
    assert got.is_contiguous() and torch.equal(got, qconv.qconv3x3_plain(xq, wq, sw, s, bias, dt))


# -- bundles against StreamingSR -------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_bundle_equals_streaming_sr(float_bundles, variant):
    """A float32 bundle served window by window equals the port's live
    StreamingSR bit for bit, across a reset and windows of every length."""
    path, sd, cls = float_bundles[variant]
    served = ExportedStream(path, device="cpu")
    assert served.meta["variant"] == cls.__name__
    live = StreamingSR(_port(sd, cls), None, RES, WINDOW, device="cpu")
    wins = make_windows(4, seed=1)
    wins[2] = wins[2][:, :37]
    _assert_streams_equal(live, served, wins)
    live.reset()
    served.reset()
    _assert_streams_equal(live, served, make_windows(3, seed=2))


@pytest.mark.parametrize("variant", ["plain", "full"])
def test_bundle_matches_jax_streaming_sr(float_bundles, jax_models, variant):
    """The same bundle against the JAX StreamingSR on the same weights."""
    path, _, _ = float_bundles[variant]
    jm, jv = jax_models[variant]
    live = jstreaming.StreamingSR(jm, jv, RES, window_size=WINDOW)
    _assert_streams_equal(live, ExportedStream(path, device="cpu"), make_windows(4, seed=3),
                          exact=False)


@pytest.mark.parametrize("quant,static", [(True, False), (True, True), ("pall", True),
                                          ("chainq", True)])
def test_int8_bundle_equals_streaming_sr(float_bundles, tmp_path, quant, static):
    """int8 bundles on dynamic scales (per call, per lane) and on static
    scales from ``calibrate_act_scales`` (baked in; the fused and chained
    modes run quantize_act, quant_matmul and the int8-emitting conv) equal
    StreamingSR in the same dtype bit for bit, and carry their int8
    weights: the program holds every QuantConv's frozen weights."""
    sd = float_bundles["plain"][1]
    model = (_calibrated(sd, quant) if static
             else _port(sd, dtype=torch.bfloat16, quant=quant))
    assert bool(act_scales(model)) == static
    path = export_serving_bundle(model, None, str(tmp_path / "q"), RES, WINDOW, device="cpu")
    served = ExportedStream(path, device="cpu")
    assert served.meta["quant"] is True and served.meta["quant_static"] is static
    assert served.meta["carry_dtypes"] == ["bfloat16", "bfloat16"]
    live = StreamingSR(model, None, RES, WINDOW, device="cpu")
    _assert_streams_equal(live, served, make_windows(4, seed=12))
    names = {n for n, _ in served._step.named_buffers()}
    for conv in quant_convs(model):
        assert f"model.{conv}.frozen_wq" in names and f"model.{conv}.frozen_sw" in names
        assert all(m.frozen_wq is None for m in quant_convs(model).values())


def test_int8_batched_lanes_equal_solo_bundle(float_bundles, tmp_path):
    """A batch-2 dynamic int8 bundle: activation scales are per lane, so
    each lane computes exactly what a batch-1 bundle computes on its stream,
    even where one lane piles every event on one pixel."""
    model = _port(float_bundles["plain"][1], dtype=torch.bfloat16, quant=True)
    b2 = ExportedStream(export_serving_bundle(model, None, str(tmp_path / "b2"), RES, WINDOW,
                                              batch=2, device="cpu"), device="cpu")
    b1 = ExportedStream(export_serving_bundle(model, None, str(tmp_path / "b1"), RES, WINDOW,
                                              batch=1, device="cpu"), device="cpu")
    wins = make_windows(3, batch=2, seed=31)
    for ev in wins:
        ev[1, 0, :], ev[1, 1, :] = 3, 4
    batched = [b2.push(ev) for ev in wins]
    assert batched[1].shape == (2, RES[0] * 2, RES[1] * 2, 2)
    for lane in range(2):
        b1.reset()
        solo = [b1.push(ev[lane]) for ev in wins]
        for got, want in zip(batched[1:], solo[1:]):
            np.testing.assert_array_equal(got[lane], want[0])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_meta_matches_jax_bundle(jax_models, tmp_path, dtype):
    """The keys both bundles write hold the JAX bundle's values for the same
    model and dtype; the port adds ``device`` and ``torch_version``."""
    kw = {} if dtype == "float32" else {"dtype": jnp.bfloat16, "quant": True}
    jm = JBMCNetPlain(scale=2, n_c=8, n_b=2, **kw)
    jexport.export_serving_bundle(jm, jax_models["plain"][1], str(tmp_path / "j"), RES,
                                  window_size=WINDOW, batch=2)
    pkw = {} if dtype == "float32" else {"dtype": torch.bfloat16, "quant": True}
    export_serving_bundle(_port(params_from_jax(jax_models["plain"][1]), **pkw), None,
                          str(tmp_path / "p"), RES, WINDOW, batch=2, device="cpu")
    want = json.load(open(tmp_path / "j" / "meta.json"))
    got = json.load(open(tmp_path / "p" / "meta.json"))
    assert {k: got[k] for k in SHARED_META} == {k: want[k] for k in SHARED_META}
    assert got["device"] == "cpu" and got["torch_version"] == torch.__version__
    assert sorted(os.listdir(tmp_path / "p")) == ["meta.json", "step.pt2"]


# -- the stream's guards and state ---------------------------------------------------


def test_wrong_batch_and_overflow_rejected(float_bundles):
    served = ExportedStream(float_bundles["plain"][0], device="cpu")
    with pytest.raises(ValueError, match="batch"):
        served.push(np.zeros((2, 4, WINDOW), np.float32))
    with pytest.raises(ValueError, match="exceeds window_size"):
        served.push(np.zeros((4, WINDOW + 1), np.float32))
    assert served.windows_seen == 0


def test_reset_restarts_stream(float_bundles):
    served = ExportedStream(float_bundles["full"][0], device="cpu")
    wins = make_windows(3, seed=9)
    first = [served.push(ev) for ev in wins]
    served.reset()
    second = [served.push(ev) for ev in wins]
    assert first[0] is None and second[0] is None
    for a, b in zip(first[1:], second[1:]):
        np.testing.assert_array_equal(a, b)


def test_export_leaves_the_model_as_it_was(float_bundles, tmp_path):
    """Tracing runs the model on fake tensors: afterwards the module's eager
    forward (and every cache it reads) is unchanged, the int8 weights are
    thawed, and freezing refuses a model that is calibrating."""
    model = _calibrated(float_bundles["plain"][1], "pall")
    live = StreamingSR(model, None, RES, WINDOW, device="cpu")
    wins = make_windows(3, seed=4)
    before = [live.push(ev) for ev in wins]
    export_serving_bundle(model, None, str(tmp_path / "e"), RES, WINDOW, device="cpu")
    live.reset()
    after = [live.push(ev) for ev in wins]
    for a, b in zip(before[1:], after[1:]):
        assert type(b) is np.ndarray
        np.testing.assert_array_equal(a, b)
    convs = quant_convs(model)
    assert all(m.frozen_wq is None for m in convs.values())
    assert not any("frozen" in k for k in model.state_dict())
    next(iter(convs.values())).calib = {"act_max": None}
    with pytest.raises(RuntimeError, match="calibration"):
        with frozen_weights(model):
            pass


def test_bundle_refuses_another_device(float_bundles, tmp_path):
    """A program runs where it was traced: a bundle exported on CUDA does not
    load for the CPU."""
    meta = json.load(open(os.path.join(float_bundles["plain"][0], "meta.json")))
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(dict(meta, device="cuda:0"), f)
    with pytest.raises(ValueError, match="export where you serve"):
        ExportedStream(str(tmp_path), device="cpu")


# -- the CLI and the consumer ------------------------------------------------------


def test_cli_export_from_golden_checkpoint(tmp_path, capsys):
    """cli.export loads the checkpoint, exports on the CPU, and the bundle
    serves what StreamingSR serves from the same checkpoint."""
    out = str(tmp_path / "bundle")
    export_main(["--model_path", GOLDEN, "--output_path", out, "--variant", "plain",
                 "--scale", "2", "--n_c", "8", "--n_b", "2", "--height", str(RES[0]),
                 "--width", str(RES[1]), "--window", str(WINDOW), "--device", "cpu"])
    assert "wrote serving bundle" in capsys.readouterr().out
    model = load_model_for_inference(GOLDEN, scale=2, n_c=8, n_b=2, variant="plain",
                                     device="cpu")
    live = StreamingSR(model, None, RES, WINDOW, device="cpu")
    served = ExportedStream(out, device="cpu")
    _assert_streams_equal(live, served, make_windows(3, seed=2))


def test_cli_int8_calibrates_static_scales(tmp_path):
    """--dtype int8 --calib_h5 bakes static scales into the bundle (from a
    fixture written by the port's packager), and meta records them."""
    out = str(tmp_path / "bundle_q")
    h5 = write_synthetic_fixture(str(tmp_path / "calib.h5"), sensor_resolution=RES,
                                 prefixes=("ori",), events_per_scale={"ori": WINDOW * 6}, seed=5)
    export_main(["--model_path", GOLDEN, "--output_path", out, "--variant", "plain",
                 "--scale", "2", "--n_c", "8", "--n_b", "2", "--height", str(RES[0]),
                 "--width", str(RES[1]), "--window", str(WINDOW), "--dtype", "int8",
                 "--batch", "2", "--calib_h5", h5, "--calib_windows", "3", "--device", "cpu"])
    served = ExportedStream(out, device="cpu")
    meta = served.meta
    assert meta["quant"] is True and meta["quant_static"] is True and meta["batch"] == 2
    assert meta["quant_mode"] == "xla"
    preds = [served.push(ev) for ev in make_windows(3, batch=2, seed=6)]
    assert preds[0] is None and np.isfinite(preds[2]).all()


def test_consumer_imports_neither_models_nor_jax(float_bundles):
    """A process that serves a bundle imports the operators, never the
    models, the engine or JAX."""
    code = (
        "import sys, numpy as np\n"
        "from bmcnet_esr_torch.inference.export import ExportedStream\n"
        f"s = ExportedStream({float_bundles['full'][0]!r}, device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        f"wins = [np.stack([rng.integers(0, {RES[1]}, 64), rng.integers(0, {RES[0]}, 64),\n"
        "                  np.linspace(0, 1, 64), rng.integers(0, 2, 64) * 2 - 1]).astype('f4')\n"
        "        for _ in range(3)]\n"
        "preds = [s.push(w) for w in wins]\n"
        "assert preds[0] is None and np.isfinite(preds[2]).all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bmcnet_esr_tpu')\n"
        "             or m.startswith(('bmcnet_esr_torch.models', 'bmcnet_esr_torch.inference.e"
        "ngine', 'bmcnet_esr_torch.inference.streaming')))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
