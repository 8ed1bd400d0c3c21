"""The yardstick: K1's and K2's operations and bytes on hand-made
launches, and the roofline share worked out from them."""

import pytest

from portbench import work
from portbench.trace import Launches


def test_peaks():
    assert work.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    assert work.HBM_BYTES_PER_S == 3.35e12


def test_k1_work():
    # 2 lanes of 1536 columns, 3 chunks, 2,500 rows, 1,000,000 band cells
    ops, nb = work.k1_work(1_000_000, 2_500, 3, 2, 1536, 8)
    assert ops == 20_000_000
    assert nb == 2_500 + 3 * 1536 + 1_000_000 + 16 * 2 * 1536 + 12 * 2 * 8
    assert work.ideal_s(ops, nb) == pytest.approx(ops / work.INT32_OPS_PER_S)


def test_k2_work():
    ops, nb = work.k2_work(640, 10)
    assert ops == 3200
    assert nb == 2 * 640 + 40 * 10
    # few cells a hit: the bytes bound
    assert work.ideal_s(*work.k2_work(10, 1000)) == pytest.approx(
        (20 + 40_000) / work.HBM_BYTES_PER_S)


class Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_roofline_share():
    k = Launches()
    k.events["xdrop_scan_launch"] = [(Event(0.0), Event(2.0)),
                                     (Event(5.0), Event(7.0))]
    k.work["xdrop_scan_launch"] = [(1_000_000, 100), (3_000_000, 100)]
    got = k.roofline("xdrop_scan_launch")
    ideal = sum(work.ideal_s(*work.k2_work(c, h)) for c, h in
                k.work["xdrop_scan_launch"])
    assert got["measured_s"] == pytest.approx(0.004)
    assert got["share"] == pytest.approx(100 * ideal / 0.004)
    assert k.roofline("ydrop_mega_launch") is None
