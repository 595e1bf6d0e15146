"""Cells shrunk to a size a CPU test can hold: the model's widths cut
(``n_c`` 8, ``n_b`` 2), 12x16 windows of 256 events, short recordings and
clips.  The modes, the program's entry points and the checks are the
cells' own."""

from typing import Dict

CONFIG = {"model": {"variant": "full", "n_c": 8, "n_b": 2, "repeat": 3, "scale": 4},
          "lr_resolution": [12, 16], "hr_resolution": [48, 64], "window": 256,
          "gt_window": 4096}

PER_MODE = {
    "infer_rollout": {"mix": {"pairs": 6, "warm_pairs": 3, "distinct_recordings": 2},
                      "settings": {"chunk_size": 4}},
    "train": {"mix": {"distinct_batches": 4, "length": 4}},
}

SECONDS = {"infer_rollout": 0.5, "train": 1.0}


def overrides(mode: str, extra: Dict = None) -> Dict:
    out = {"config": dict(CONFIG)}
    for k, v in PER_MODE[mode].items():
        out[k] = dict(v)
    for k, v in (extra or {}).items():
        out[k] = {**out.get(k, {}), **v}
    return out


def run(harness, workload: str, seed: int = 2**31 + 17, extra: Dict = None) -> Dict:
    import torch

    torch.set_num_threads(2)
    mode = harness.cell_files(workload)["mode"]
    return harness.run_cell(workload, seed, SECONDS[mode], False, device="cpu",
                            overrides=overrides(mode, extra))
