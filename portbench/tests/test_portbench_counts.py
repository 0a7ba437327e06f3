"""The counting functions against MACs and bytes worked by hand."""

import pytest

from portbench import counts as C
from portbench.reference import models as M


@pytest.mark.parametrize("k,taps", [(1, 1), (3, 2), (5, 3), (7, 4)])
def test_distinct_taps(k, taps):
    assert C.distinct_taps(k) == taps


# G32up-c's three stages a sample: (input h, cin, cout, k) -> MACs of the
# distinct taps: 8*8*512*512*2*2, 16*16*256*512*2*2, 32*32*128*256*3*3
G32UPC_STAGES = [
    (4, 512, 512, 3, 8 * 8 * 512 * 512 * 4),
    (8, 512, 256, 3, 16 * 16 * 256 * 512 * 4),
    (16, 256, 128, 5, 32 * 32 * 128 * 256 * 9),
]


@pytest.mark.parametrize("h,cin,cout,k,macs", G32UPC_STAGES)
def test_g32upc_stage_macs_and_bytes(h, cin, cout, k, macs):
    op = C.upconv("s", 1, h, h, cin, cout, k)
    assert op.macs == macs
    assert op.bytes == 4 * (h * h * cin + cout * cin * k * k + cout
                            + 4 * h * h * cout)
    assert C.upconv("s", 640, h, h, cin, cout, k).macs == 640 * macs


def test_g32upc_table_holds_the_three_stages():
    ups = [op.macs for op in M.g32upc_ops(1) if op.kind == "upconv"]
    assert ups == [m for *_, m in G32UPC_STAGES]
    assert sum(ups) == 503_316_480


def test_refine_stage():
    # upsample + conv 5x5 64 -> 64 at 32x32 -> 64x64: 64*64*64*64*3*3
    ops = {op.name: op for op in M.refine_ops(1)}
    assert ops["refine.upconv"].macs == 64 * 64 * 64 * 64 * 9
    assert ops["refine.conv1"].macs == 32 * 32 * 64 * 3 * 9
    assert ops["refine.conv2"].macs == 64 * 64 * 32 * 64 * 9
    assert ops["refine.head"].macs == 64 * 64 * 3 * 35 * 9


def test_nn_search():
    op = C.nn_search(16, 100_000, 3072)
    assert op.macs == 16 * 100_000 * 3072
    assert op.bytes == 4 * (100_000 * 3072 + 16 * 3072) + 12 * 16
    # bandwidth-bound: the corpus read once at 3.35 TB/s
    assert C.least_seconds(op.macs, op.bytes) == pytest.approx(
        op.bytes / 3.35e12)


def test_f32_row3_reading_stays_under_the_peak():
    """The 3xTF32 upsample-conv forward's 9.5105 ms of device time at
    B=640 (PERF.md, the kernel table's row 3) is 101% of a 67 TFLOP/s f32
    bound but under 100% of the TF32 rate the count holds f32 work to."""
    macs = sum(op.macs for op in M.g32upc_ops(640) if op.kind == "upconv")
    assert 2 * macs / 67e12 * 1e3 == pytest.approx(9.6156, abs=1e-4)
    least = C.least_seconds(macs, 0)
    share = C.share_percent(least, 9.5105e-3)
    assert share < 100.0
    assert share == pytest.approx(13.685, abs=1e-3)


def test_sampler_bytes():
    # (n, h, w, c) image at p points: image + coordinates read, out written
    assert C.sampler_forward_bytes(2, 4, 4, 3, 16) == 4 * (
        2 * 48 + 2 * 32 + 2 * 48)
    assert C.sampler_dcoords_bytes(1, 2, 2, 1, 4) == 4 * (4 + 8 + 4 + 8)
    assert C.sampler_dimg_bytes(1, 2, 2, 1, 4) == 4 * (8 + 4 + 4)


def test_gan_step_counts_each_pass_once():
    g = [C.Op("g0", "dense", 10, 0, True, True),
         C.Op("g1", "conv", 100, 0, True, False)]
    d = [C.Op("d0", "conv", 7, 0, True, True),
         C.Op("d1", "dense", 3, 0, True, False)]
    # D phase: G fwd 110 + D fwd 10 + D wgrad 10 + D dgrad 3 (not d0's
    # input); G phase: G fwd 110 + D fwd 10 + D dgrad 10 + G wgrad 110 +
    # G dgrad 100 (not g0's input, the noise)
    assert C.gan_step_macs(g, g, d) == (110 + 10 + 10 + 3) + (
        110 + 10 + 10 + 110 + 100)


def test_shares_are_never_zero_for_nothing():
    assert C.share_percent(1.0, None) is None
    assert C.share_percent(1.0, 0.0) is None
