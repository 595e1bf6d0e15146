"""The traffic generator: deterministic per seed, the cells' shapes."""

import numpy as np
import pytest

from benchmark import traffic

EVENTS = {"edges": 3, "background_share": 0.2, "edge_width_px": 0.8, "speed_px_per_window": 0.6}


@pytest.mark.parametrize("hw,n", [((45, 80), 2048), ((180, 190), 16384)])
def test_windows_are_the_seeds_and_keep_to_the_sensor(hw, n):
    seed = 2**33 + 5  # more than 32 bits
    a = traffic.stream_windows(seed, 3, 0, 6, hw, n, EVENTS)
    assert a.shape == (6, 4, n) and a.dtype == np.float32
    np.testing.assert_array_equal(a, traffic.stream_windows(seed, 3, 0, 6, hw, n, EVENTS))
    np.testing.assert_array_equal(a[2:5], traffic.stream_windows(seed, 3, 2, 3, hw, n, EVENTS))
    assert not np.array_equal(a, traffic.stream_windows(seed + 1, 3, 0, 6, hw, n, EVENTS))
    x, y, t, p = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    assert (x >= 0).all() and (x < hw[1]).all() and (y >= 0).all() and (y < hw[0]).all()
    assert (x == np.floor(x)).all() and (y == np.floor(y)).all()
    assert set(np.unique(p)) == {-1.0, 1.0} and abs(p.mean()) < 0.2
    assert (np.diff(t, axis=1) >= 0).all() and (t[:, 0] >= np.arange(6)).all()
    # edge-clustered: far fewer distinct pixels than uniform events would hit
    img = np.zeros(hw)
    np.add.at(img, (y[0].astype(int), x[0].astype(int)), 1)
    uniform = hw[0] * hw[1] * (1 - np.exp(-n / (hw[0] * hw[1])))
    assert (img > 0).sum() < 0.8 * uniform

