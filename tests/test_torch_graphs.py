"""The CUDA graphs of the file rollout (``inference/graphs.py``).

On the card (tests marked ``cuda``, which skip without one): graphed
rollouts against the same engine with its graphs off, bit for bit, for
BMCNet and BMCNetPlain in float32, bf16 and every int8 dtype at batch 1 and
2, over two recordings whose calibrations give different int8 scales;
states and predictions a forward hook keeps are never overwritten by a
later replay; the ``launches`` counters count Python calls only, so a
replay adds nothing to them; one capture for a key.

On the CPU: the engine builds no graphs.  With the device check stubbed and
a stand-in for CUDA's capture (:class:`_EagerGraph`, which replays the
body eagerly on the captured static tensors), the rest of the mechanism
runs here: the same rollouts, the scales copied in place, fresh outputs,
the counters, the spans, the one graph an engine keeps, and the paths that
must stay eager (calibration, the flop count, fake tensors, other threads,
training, serving, export, mesh replicas).

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -q
"""

import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from bmcnet_esr_torch.data import DatasetConfig
from bmcnet_esr_torch.inference import InferenceEngine, StreamingSR, StreamPool, graphs
from bmcnet_esr_torch.inference.engine import DTYPES, INT8_DTYPES
from bmcnet_esr_torch.inference.export import export_serving_bundle
from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize
from bmcnet_esr_torch.models import BMCNet, BMCNetPlain, act_scales, calibrate_act_scales
from bmcnet_esr_torch.ops.batch import compact_events
from bmcnet_esr_torch.parallel import make_mesh
from bmcnet_esr_torch.training.train_step import sequence_loss
from bmcnet_esr_torch.utils import strict_fp32, timers

H, W, SCALE = 24, 32, 4
WINDOWS, CHUNK = 7, 4  # two chunks: 4 and 3 window pairs
KERNELS = (rasterize, quantize, qconv, qmm)
FAKE_LAUNCHES = 3  # qconv calls the CPU stand-in's capture makes
ALL_DTYPES = ("float32", "bfloat16", *INT8_DTYPES)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _EagerGraph:
    """``torch.cuda.CUDAGraph``'s part on the CPU: a replay runs the body
    on the static inputs, with the scale tensors present at capture
    installed, into the static outputs."""

    def __init__(self, model, inputs, outputs, bound):
        self.model, self.inputs, self.outputs, self.bound = model, inputs, outputs, bound

    def replay(self):
        held = [m.act_scale for m, _ in self.bound]
        for m, s in self.bound:
            m.act_scale = s
        try:
            outs = self.model._body(*self.inputs)
        finally:
            for (m, _), s in zip(self.bound, held):
                m.act_scale = s
        for o, r in zip(self.outputs, outs):
            o.copy_(r)


def _stub_capture(monkeypatch, captures):
    """Graphs on the CPU; every capture is appended to ``captures`` and
    makes ``FAKE_LAUNCHES`` qconv calls, as a capture on the card calls the
    kernels' wrappers once each."""
    monkeypatch.setattr(graphs, "available", lambda device: True)
    monkeypatch.setattr(graphs.ForwardGraphs, "_warm_up",
                        lambda self, inputs: self.model._body(*inputs))

    def record(self, inputs):
        captures.append(tuple(t.shape for t in inputs))
        qconv.launches += FAKE_LAUNCHES
        bound = [(m, m.act_scale) for m in self._convs]
        outputs = [t.clone() for t in self.model._body(*inputs)]
        return _EagerGraph(self.model, inputs, outputs, bound), outputs

    monkeypatch.setattr(graphs.ForwardGraphs, "_record", record)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def graphing(request, monkeypatch):
    """``(device, captures)``: graphs on the card, or the CPU stand-in."""
    captures = []
    if request.param == "cpu":
        _stub_capture(monkeypatch, captures)
        return torch.device("cpu"), captures
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    strict_fp32()
    record = graphs.ForwardGraphs._record

    def counted(self, inputs):
        captures.append(tuple(t.shape for t in inputs))
        return record(self, inputs)

    monkeypatch.setattr(graphs.ForwardGraphs, "_record", counted)
    return torch.device("cuda"), captures


@pytest.fixture
def cpu_graphs(monkeypatch):
    captures = []
    _stub_capture(monkeypatch, captures)
    return captures


def _recording(seed, batch, events):
    """Compact input windows ``[WINDOWS + 1, batch]`` and GT windows
    ``[WINDOWS, batch]``, ``events`` input events a window."""
    rng = np.random.default_rng(seed)

    def windows(n, hw, count):
        ev = np.zeros((n, batch, 4, count), np.float32)
        ev[:, :, 0] = rng.integers(0, hw[1], (n, batch, count))
        ev[:, :, 1] = rng.integers(0, hw[0], (n, batch, count))
        ev[:, :, 3] = rng.integers(0, 2, (n, batch, count)) * 2 - 1
        return compact_events(ev)

    inp = windows(WINDOWS + 1, (H, W), events)
    gt = windows(WINDOWS, (SCALE * H, SCALE * W), 4 * events)

    def load_chunk(pos, steps):
        return ((inp[0][pos:pos + steps + 1], inp[1][pos:pos + steps + 1]),
                (gt[0][pos:pos + steps], gt[1][pos:pos + steps]))

    return load_chunk


# two recordings of one shape whose int8 calibrations differ: sparse, then dense
RECORDINGS = ((11, 48), (12, 400))


def _model(dtype, device, variant="full"):
    cls = BMCNet if variant == "full" else BMCNetPlain
    m = cls(scale=SCALE, n_c=16, n_b=2, dtype=DTYPES.get(dtype, torch.bfloat16),
            quant=INT8_DTYPES.get(dtype, False), generator=torch.Generator().manual_seed(5))
    return m.to(device)


def _engine(dtype, device, graphed=True, variant="full"):
    eng = InferenceEngine(_model(dtype, device, variant), DatasetConfig(scale=SCALE),
                          chunk_size=CHUNK, visualize=False, device=device)
    if not graphed:
        eng._graphs = None  # the same engine with its graphs off
    return eng


class _Keep:
    """Forward hook: every state and prediction the model returns, by
    reference and as copies taken when they were returned."""

    def __init__(self, model):
        self.kept = []
        self.handle = model.register_forward_hook(self)

    def __call__(self, module, args, out):
        self.kept.append((out, tuple(t.clone() for t in out)))


def _roll(eng, batch):
    """Both recordings through ``eng``: per-window MSEs, what the hook
    kept, each recording's scales and kernel launches."""
    keep = _Keep(eng.model)
    esr, scales, launches = [], [], []
    for seed, events in RECORDINGS:
        before = [mod.launches for mod in KERNELS]
        out = eng.infer_windows_batch(_recording(seed, batch, events), [WINDOWS] * batch,
                                      (H, W), (SCALE * H, SCALE * W), return_per_window=True)
        launches.append([mod.launches - n for mod, n in zip(KERNELS, before)])
        esr.append(np.stack([r["per_window"]["esr_mse"] for r in out]))
        scales.append({k: v.clone() for k, v in act_scales(eng.model).items()})
    keep.handle.remove()
    return esr, keep.kept, scales, launches


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("variant", ["full", "plain"])
def test_graphed_rollouts_equal_the_engine_with_graphs_off(graphing, variant, dtype, batch):
    """Two recordings, each calibrated anew in int8 (to other scales: the
    second replays must read the second recording's, also where a conv
    emits at the next conv's scale, ``int8_chain``), bit for bit against the
    same engine with its graphs off: every window's ``esr_mse``, states and
    prediction.  No state or prediction a hook kept changed after later
    replays.  One capture, in the first rollout."""
    device, captures = graphing
    got = _roll(_engine(dtype, device, variant=variant), batch)
    assert len(captures) == 1
    want = _roll(_engine(dtype, device, graphed=False, variant=variant), batch)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == len(want[1])
    for (g, _), (w, _) in zip(got[1], want[1]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    for ref, copy in got[1]:  # held by reference across later replays and rollouts
        assert all(torch.equal(a, b) for a, b in zip(ref, copy))
    if dtype.startswith("int8"):
        first, second = got[2]
        assert any(not torch.equal(first[k], second[k]) for k in first)
        for g, w in zip(got[2], want[2]):
            assert all(torch.equal(g[k], w[k]) for k in w)


def _counted_rollout(eng):
    """Each kernel's ``launches`` in one rollout after a warm-up one (which
    captures)."""
    load = _recording(11, 1, 48)
    eng.infer_windows(load, WINDOWS, (H, W), (SCALE * H, SCALE * W))
    before = [mod.launches for mod in KERNELS]
    eng.infer_windows(load, WINDOWS, (H, W), (SCALE * H, SCALE * W))
    return {mod: mod.launches - n for mod, n in zip(KERNELS, before)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8_pall", "int8_pquant"])
def test_replays_make_no_python_launch_on_cuda(dtype):
    """The ``launches`` counters count Python calls: a graphed rollout that
    does not capture counts calibration's and the rasterizer's launches
    alone, the eager one the model's sites a window besides.  (The device
    trace counts a replay's kernels: ``chip_smoke.py``'s rollouts phase.
    No profiler runs here: a later CUDA-only profile in the same process
    then lost every device record.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    strict_fp32()
    cuda = torch.device("cuda")
    got = _counted_rollout(_engine(dtype, cuda))
    want = _counted_rollout(_engine(dtype, cuda, graphed=False))
    n3, n1 = 11 + 20 * 2, 3 * 7 * 2  # the model's 3x3 and 1x1 sites at n_b 2
    per_window = {rasterize: 0, qconv: n3, qmm: n1 if dtype == "int8_pall" else 0,
                  quantize: n3 if dtype == "int8_pquant" else 0}
    assert want[rasterize] > 0 and want[qconv] > WINDOWS * n3  # calibration's besides
    assert got == {mod: want[mod] - WINDOWS * per_window[mod] for mod in KERNELS}


def test_the_engine_builds_no_graphs_on_the_cpu():
    eng = _engine("int8_pall", torch.device("cpu"))
    seen = []
    eng.model.register_forward_hook(lambda m, a, o: seen.append(m._graphs))
    eng.infer_windows(_recording(11, 1, 48), WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert eng._graphs is None and seen and set(seen) == {None}


def test_replays_leave_the_launch_counters_alone(cpu_graphs):
    """The counters count the wrappers' Python calls: the stand-in's
    capture makes ``FAKE_LAUNCHES`` qconv calls, and they count; replays
    make none (the plain versions the CPU runs count none either)."""
    eng = _engine("float32", torch.device("cpu"))
    launches = _roll(eng, 2)[3]
    assert len(cpu_graphs) == 1
    assert launches == [[FAKE_LAUNCHES if mod is qconv else 0 for mod in KERNELS],
                        [0] * len(KERNELS)]


def test_capture_and_replay_spans(cpu_graphs):
    eng = _engine("bfloat16", torch.device("cpu"))
    load = _recording(11, 2, 48)
    timers.clear()
    with timers.record():
        eng.infer_windows_batch(load, [WINDOWS] * 2, (H, W), (SCALE * H, SCALE * W))
        eng.infer_windows_batch(load, [WINDOWS] * 2, (H, W), (SCALE * H, SCALE * W))
    kept = timers.spans()
    timers.clear()
    by_id = {s.id: s for s in kept}
    names = [s.name for s in kept]
    assert names.count("rollout.capture") == 1 and names.count("rollout.replay") == 2 * WINDOWS
    for s in kept:
        if s.name in ("rollout.capture", "rollout.replay"):
            assert by_id[s.parent].name == "rollout.forward"
    assert {s.attrs["windows"] for s in kept if s.name == "rollout.replay"} == {2}


def test_calibration_flops_fakes_and_other_threads_stay_eager(cpu_graphs):
    """Installed, the graphs serve none of these calls: calibration's
    forwards, a forward under the flop counter, a call from another thread,
    and fake tensors (a dispatch mode, as the flop counter)."""
    eng = _engine("int8_pall", torch.device("cpu"))
    model, runner = eng.model, eng._graphs
    x = torch.poisson(torch.full((2, 1, 2, H, W, 2), 0.5))
    carry = model.init_state(1, H, W)
    with torch.inference_mode(), runner.installed():
        calibrate_act_scales(model, x, carry)
        with FlopCounterMode(display=False):
            model(x[0], *carry)
        with FakeTensorMode():
            assert not runner.engages()

        def other():
            with torch.inference_mode():
                model(x[0], *carry)

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert runner.engages()
    assert model._graphs is None and runner.graph is None and not cpu_graphs


def test_training_serving_and_export_stay_eager_after_a_rollout(cpu_graphs, tmp_path):
    """A training loss and its backward, StreamingSR, StreamPool and
    ``torch.export`` of the serving step on the engine's model run outside
    any rollout: no capture, and the model holds no graphs then."""
    eng = _engine("bfloat16", torch.device("cpu"))
    eng.infer_windows(_recording(11, 1, 48), WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 1 and eng.model._graphs is None
    rng = np.random.default_rng(3)

    def events(hw, n):
        ev = np.zeros((1, 3, 4, n), np.float32)
        ev[:, :, 0], ev[:, :, 1] = rng.integers(0, hw[1], (1, 3, n)), rng.integers(0, hw[0], (1, 3, n))
        ev[:, :, 3] = rng.integers(0, 2, (1, 3, n)) * 2 - 1
        return torch.from_numpy(ev)

    batch = {"inp_events": events((H, W), 48), "gt_events": events((SCALE * H, SCALE * W), 192)}
    total, _ = sequence_loss(eng.model, batch, (H, W), (SCALE * H, SCALE * W), use_remat=False)
    total.backward()
    assert eng.model.neuro.conv_o.weight.grad is not None

    def window():
        ev = np.zeros((4, 64), np.float32)
        ev[0], ev[1] = rng.integers(0, W, 64), rng.integers(0, H, 64)
        ev[3] = rng.integers(0, 2, 64) * 2 - 1
        return ev

    stream = StreamingSR(eng.model, None, (H, W), window_size=64, device="cpu")
    assert stream.push(window()) is None and stream.push(window()) is not None
    pool = StreamPool(eng.model, None, (H, W), slots=2, window_size=64, device="cpu")
    slot = pool.attach()
    pool.push({slot: window()})
    assert slot in pool.push({slot: window()})
    export_serving_bundle(eng.model, None, str(tmp_path / "bundle"), (H, W), 64, device="cpu")
    assert len(cpu_graphs) == 1 and eng.model._graphs is None


def test_mesh_replicas_stay_eager(cpu_graphs):
    """A rollout that a mesh splits runs its shards eagerly; a batch-1
    rollout of the same engine, on the solo shard, captures."""
    eng = InferenceEngine(_model("float32", "cpu"), DatasetConfig(scale=SCALE), chunk_size=CHUNK,
                          visualize=False, mesh=make_mesh(2, devices=["cpu", "cpu"]), device="cpu")
    eng.infer_windows_batch(_recording(11, 2, 48), [WINDOWS] * 2, (H, W), (SCALE * H, SCALE * W))
    assert not cpu_graphs
    eng.infer_windows(_recording(11, 1, 48), WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 1


def test_written_weights_and_new_shapes_capture_again(cpu_graphs):
    """The engine keeps one graph, the last key's: the same key never
    captures twice in a row; another batch or resolution captures and drops
    the graph before; so does a rollout after the parameters were written."""
    eng = _engine("float32", torch.device("cpu"))
    one = _recording(11, 1, 48)
    for _ in range(2):
        eng.infer_windows(one, WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 1
    first = eng._graphs.graph
    eng.infer_windows_batch(_recording(11, 2, 48), [WINDOWS] * 2, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 2 and eng._graphs.graph is not first
    assert eng._graphs.graph.inputs[0].shape[0] == 2
    eng.infer_windows(one, WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 3 and eng._graphs.graph.inputs[0].shape[0] == 1
    with torch.no_grad():
        eng.model.neuro.conv_o.weight.mul_(1.5)
    eng.infer_windows(one, WINDOWS, (H, W), (SCALE * H, SCALE * W))
    assert len(cpu_graphs) == 4
