"""The yardstick's arithmetic: FLOPs against ``torch.utils.flop_counter`` and
bytes against hand-worked values."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops

DIMS = {"n_c": 16, "n_b": 2, "scale": 4, "repeat": 3}


@pytest.mark.parametrize("hw", [(6, 8), (9, 10)])
def test_forward_flops_match_the_flop_counter(hw):
    from bmcnet_esr_torch.models import BMCNet

    model = BMCNet(scale=4, n_c=16, n_b=2).eval()
    x = torch.rand(1, 2, *hw, 2)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, *model.init_state(1, *hw))
    assert fc.get_total_flops() == flops.forward_flops(DIMS, hw)


def test_full_model_per_pixel_counts():
    dims = {"n_c": 128, "n_b": 5, "scale": 4, "repeat": 3}
    calls = flops.conv_calls(**dims)
    mac3 = sum(ci * co * 9 * n for _, ci, co, k, n in calls if k == 3)
    mac1 = sum(ci * co * n for _, ci, co, k, n in calls if k == 1)
    assert (mac3, mac1) == (17_346_816, 2_457_600)
    assert sum(n for *_, k, n in calls if k == 3) == 111
    assert sum(n for *_, k, n in calls if k == 1) == 105


def test_kernel_bytes_by_hand():
    # 32 windows of 2048 compact events (5 bytes each) into 45x80x2 float32 images
    assert flops.raster_call(32, 2048, (45, 80)) == (32 * 2048.0, 32 * (2048 * 5 + 28800.0))
    # conv_hs at 2x3: bf16 in (2 x 6 x 128), int8 weights 9 x 128 x 128, sw + bias, sx, bf16 out
    calls = flops.qconv_calls({"n_c": 128, "n_b": 5, "scale": 4, "repeat": 3}, (2, 3), 1, 2)
    ops, nbytes = calls[-2]  # conv_hn
    assert ops == 2 * 6 * 9 * 128 * 128
    assert nbytes == 6 * 128 * 2 + 9 * 128 * 128 + 8 * 128 + 4 + 6 * 128 * 2
    mm = flops.qmm_calls({"n_c": 128, "n_b": 5, "scale": 4, "repeat": 3}, (2, 3), 1, 1)
    assert len(mm) == 105 and mm[0] == (2.0 * 6 * 256 * 128, 6 * 256 + 256 * 128 + 8 * 128 + 4
                                        + 6 * 128 * 2.0)
    assert flops.bound_s([(1e12, 1e9)], 1e15, 1e12) == pytest.approx(1e-3)
    assert flops.bound_s([(1e12, 1e6)], 1e15, 1e12) == pytest.approx(1e-3)
