"""K2's and K11's bytes and operations against hand counts at two shapes."""

from vio_benchmark.yardstick import peaks, work


def test_k2_one_instance_small():
    # 8x6 images, 2 levels (8x6, 4x3), pad 1: padded 10x8 + 6x5 = 110 floats
    b, o = work.k2_work(1, 6, 8, 2, 1)
    assert b == 2 * 48 + 2 * 110 * 4
    assert o == 20 * 2 * 12


def test_k2_fleet_euroc():
    # 63 instances, 752x480, 4 levels, pad 17
    levels = [(480, 752), (240, 376), (120, 188), (60, 94)]
    padded = sum((h + 34) * (w + 34) for h, w in levels)
    b, o = work.k2_work(63, 480, 752, 4, 17)
    assert b == 126 * 480 * 752 + 126 * padded * 4
    assert o == 20 * 126 * (240 * 376 + 120 * 188 + 60 * 94)


def test_k11_tiers_and_counts():
    D, N = 141, 20
    assert [work.update_tier(300, D, r) for r in (None, 100, 148, 200, 290)] == \
        ["all", "T1", "T2", "T2", "QR"]  # T1 = 144, T2 = 282
    assert work.update_tier(200, D, 150) == "all"  # a buffer no taller than T2
    # one instance, 26 rows of a 200-row buffer ("all" tier: m = 26)
    m = 26.0
    b, o = work.k11_work(D, 4, N, 200, [26])
    assert o == 2 * m * D * D + m * m * D + m ** 3 / 3 + 2 * m * m * D + 2 * m * D \
        + 2 * m * D * D + 3 * D * D + 40 * D
    assert b == 2 * D * D * 4 + (26 * (D + 1) + D + 1) * 4 + 2 * (28 + 7 * N) * 4
    # two instances, one on the QR tier (290 rows compressed to D)
    b2, o2 = work.k11_work(D, 8, N, 300, [290, None])
    qr = 2 * 290 * D * D + 2 * D * D * D + D * D * D + D ** 3 / 3 + 2 * D * D * D + 2 * D * D \
        + 2 * D * D * D + 3 * D * D + 40 * D
    whole = 2 * 300 * D * D + 300 * 300 * D + 300 ** 3 / 3 + 2 * 300 * 300 * D + 2 * 300 * D \
        + 2 * 300 * D * D + 3 * D * D + 40 * D
    assert o2 == qr + whole
    assert b2 == 8 * (2 * (2 * D * D + 2 * (28 + 7 * N)) + (290 + 300) * (D + 1) + 2 * (D + 1))


def test_bound():
    s, what = peaks.bound(3.35e12, 1.0)
    assert s == 1.0 and what == "bytes"
    s, what = peaks.bound(1.0, 67e12 * 2)
    assert s == 2.0 and what == "operations"
