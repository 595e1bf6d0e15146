"""The reduction of a device trace to busy time, operations and idle gaps."""

import pytest

from benchmark import devtrace

RECORDS = [("void (anonymous namespace)::qconv3x3_kernel<__nv_bfloat16, 8>(signed char const*)",
            0.0, 10.0),
           ("void at::native::elementwise_kernel<128, 2>(int)", 5.0, 12.0),
           ("void (anonymous namespace)::band_kernel<short, signed char>(short const*)", 20.0, 26.0),
           ("Memcpy HtoD (Pinned -> Device)", 30.0, 31.0)]


@pytest.mark.parametrize("name,want", [(RECORDS[0][0], "qconv3x3_kernel"),
                                       (RECORDS[1][0], "elementwise_kernel"),
                                       (RECORDS[2][0], "band_kernel"),
                                       (RECORDS[3][0], "Memcpy HtoD")])
def test_short_names(name, want):
    assert devtrace.short(name) == want


def test_busy_time_is_the_union_of_records():
    assert devtrace.busy_us(RECORDS) == 12.0 + 6.0 + 1.0


def test_ops_gaps_and_kernel_time():
    assert devtrace.top_ops(RECORDS)[0] == ["qconv3x3_kernel", pytest.approx(10e-6)]
    gaps = devtrace.idle_gaps(RECORDS)
    assert gaps[0] == ["elementwise_kernel -> band_kernel", pytest.approx(8e-6)]
    assert gaps[1] == ["band_kernel -> Memcpy HtoD", pytest.approx(4e-6)]
    assert devtrace.kernel_time_s(RECORDS, "qconv3x3_kernel") == (pytest.approx(10e-6), 1)
