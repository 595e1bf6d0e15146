"""The frozen reference against the port's CPU forward, the rasterizer and the
training step, at a small size."""

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.reference import model as ref_model
from benchmark.reference import raster
from benchmark.reference import train as ref_train
from benchmark.tests import tiny

EVENTS = {"edges": 3, "background_share": 0.2, "edge_width_px": 0.8, "speed_px_per_window": 0.6}
CONFIG = {**tiny.CONFIG, "model": {"variant": "full", "n_c": 16, "n_b": 2, "repeat": 3, "scale": 4},
          "init": {"gain": 0.1, "head_gain": 4.0, "state_gain": 1.0, "bias_std": 0.01, "norm_std": 0.1}}


def _frames(seed, n, hw=(12, 16)):
    return raster.counts(torch.from_numpy(traffic.stream_windows(seed, 0, 0, n, hw, 256, EVENTS)),
                         hw)


def test_rasterizer_matches_the_ports_plain_version():
    from bmcnet_esr_torch.kernels.rasterize import counts_plain

    ev = torch.from_numpy(traffic.stream_windows(5, 1, 0, 4, (12, 16), 256, EVENTS))
    ev[0, 0, :3] = torch.tensor([-1.0, 16.0, 3.0])  # out of range, out of range, in
    ev[1, 3, :5] = 0.0  # padding
    np.testing.assert_array_equal(raster.counts(ev, (12, 16)),
                                  counts_plain(ev[:, 0], ev[:, 1], ev[:, 3], (12, 16)))


def test_forward_matches_the_ports_forward():
    from bmcnet_esr_torch.models import BMCNet

    torch.set_num_threads(2)
    params = weights.seeded_params(CONFIG, 11, "cpu")
    port = BMCNet(scale=4, n_c=16, n_b=2).eval()
    port.load_state_dict(params, strict=True)
    net = ref_model.Net(params, **weights.model_dims(CONFIG))
    fr = _frames(3, 5)
    a, b = port.init_state(2, 12, 16), net.init_state(2, 12, 16)
    with torch.no_grad():
        for t in range(4):
            x = torch.stack([fr[t], fr[t + 1]])[None].repeat(2, 1, 1, 1, 1)
            a, b = port(x, *a), net(x, *b)
            for u, v in zip(a, b):
                torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)
            d = b[-1] - ref_model.skip_of(x, 4)
            assert 0.2 < float(d.norm() / ref_model.skip_of(x, 4).norm()) < 5.0


def test_training_steps_match_the_ports_train_step():
    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.ops.batch import compact_events
    from bmcnet_esr_torch.training.optim import build_optimizer
    from bmcnet_esr_torch.training.train_step import init_train_state, make_train_step

    torch.set_num_threads(2)
    hw, gt_hw = (12, 16), (48, 64)
    params = weights.seeded_params(CONFIG, 12, "cpu")
    batches = []
    for i in range(2):
        inp = np.stack([traffic.stream_windows(7, 2 * i + c, 0, 3, hw, 256, EVENTS) for c in (0, 1)])
        gt = np.stack([traffic.stream_windows(8, 2 * i + c, 0, 3, gt_hw, 1024, EVENTS)
                       for c in (0, 1)])
        batches.append((inp, gt))
    model = BMCNet(scale=4, n_c=16, n_b=2)
    model.load_state_dict(params)
    opt, sched = build_optimizer(model.parameters(), {"name": "Adam", "args": {
        "lr": 1e-3, "weight_decay": 1e-5, "amsgrad": True}}, {"name": "Constant"}, {})
    state = init_train_state(model, opt, sched)
    step = make_train_step(hw, gt_hw, 2, use_remat=False)
    losses = []
    for inp, gt in batches:
        (ixy, ip), (gxy, gp) = compact_events(inp), compact_events(gt)
        batch = {k: torch.from_numpy(v) for k, v in
                 {"inp_xy": ixy, "inp_p": ip, "gt_xy": gxy, "gt_p": gp}.items()}
        state, m = step(state, batch)
        losses.append(float(m["train_loss"]))
    ref = ref_train.steps(params, weights.model_dims(CONFIG),
                          [(torch.from_numpy(i), torch.from_numpy(g)) for i, g in batches],
                          hw, gt_hw, 1e-3, 1e-5)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), ref["params"][n], rtol=1e-4, atol=1e-6)
