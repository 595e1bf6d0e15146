"""The port's float32 policy does not depend on the entry point.

Every entry point that can run a float32 product turns TF32 off when it is
built (``utils/device.py::strict_fp32``), whatever the process set before:
the JAX package fixes the precision inside each op, the port through the
process-wide flags.  The check runs in a fresh interpreter that turns both
TF32 flags on before each build, so no earlier test's setting leaks in.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys, numpy as np, torch
import torch.distributed as dist

def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

def check(name):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    print(name, "OK" if flags == (False, False) else f"TF32 {flags}")

from bmcnet_esr_torch.models import BMCNet
from bmcnet_esr_torch.inference import StreamPool, StreamingSR, export_serving_bundle
from bmcnet_esr_torch.inference.export import ExportedStream
from bmcnet_esr_torch.training import make_eval_step, make_train_step
from bmcnet_esr_torch.parallel import make_process_mesh
from bmcnet_esr_torch.parallel.step import make_parallel_eval_step, make_parallel_train_step

res, gt = (6, 8), (12, 16)
model = BMCNet(scale=2, n_c=4, n_b=1, generator=torch.Generator().manual_seed(0))
builds = [
    ("StreamingSR", lambda: StreamingSR(model, None, res, 16, device="cpu")),
    ("StreamPool", lambda: StreamPool(model, None, res, slots=2, window_size=16, device="cpu")),
    ("make_train_step", lambda: make_train_step(res, gt)),
    ("make_eval_step", lambda: make_eval_step(res, gt)),
    ("export_serving_bundle",
     lambda: export_serving_bundle(model, None, sys.argv[1] + "/bundle", res, 16, device="cpu")),
    ("ExportedStream", lambda: ExportedStream(sys.argv[1] + "/bundle", device="cpu")),
]
for name, build in builds:
    tf32_on()
    build()
    check(name)
dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "/store",
                        world_size=1, rank=0)
mesh = make_process_mesh()
for name, build in (("make_parallel_train_step", lambda: make_parallel_train_step(res, gt, mesh)),
                    ("make_parallel_eval_step", lambda: make_parallel_eval_step(res, gt, mesh))):
    tf32_on()
    build()
    check(name)
dist.destroy_process_group()
"""

ENTRY_POINTS = ("StreamingSR", "StreamPool", "make_train_step", "make_eval_step",
                "export_serving_bundle", "ExportedStream", "make_parallel_train_step",
                "make_parallel_eval_step")


def test_every_float32_entry_point_turns_tf32_off(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines() if " " in line)
    for name in ENTRY_POINTS:
        assert lines.get(name) == "OK", (name, out.stdout)


def test_float64_reference_model_runs_the_float32_math():
    """``dtype=torch.float64`` (a reference for measuring float32's
    round-off) computes the float32 model's function: the same forward and
    rollout gradient within float32 round-off at n_c=8."""
    import numpy as np
    import torch

    from bmcnet_esr_torch.models import BMCNet
    from bmcnet_esr_torch.training.train_step import _rollout_losses, fill_missing_grads

    m32 = BMCNet(scale=2, n_c=8, n_b=1, generator=torch.Generator().manual_seed(0))
    m64 = BMCNet(scale=2, n_c=8, n_b=1, dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())
    m64.double()
    rng = np.random.default_rng(0)
    inp = torch.from_numpy(rng.poisson(1.0, (1, 3, 6, 8, 2)).astype(np.float32))
    gt = torch.from_numpy(rng.poisson(1.0, (1, 3, 12, 20, 2)).astype(np.float32))
    grads = []
    for m in (m32, m64):
        _, totals = _rollout_losses(m, inp, gt, 2, (12, 20), use_remat=False)
        totals.sum().backward()
        fill_missing_grads(m)
        grads.append(torch.cat([p.grad.reshape(-1).double() for p in m.parameters()]))
        assert all(p.grad.dtype == next(m.parameters()).dtype for p in m.parameters())
    rel = float(torch.linalg.vector_norm(grads[0] - grads[1]) / torch.linalg.vector_norm(grads[1]))
    assert 0 < rel < 1e-5
