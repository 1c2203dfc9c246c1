"""The yardstick's counts against hand counts at small sizes."""

import random

import pytest

from port_bench import cost


def test_product_and_peaks():
    assert cost.PRODUCT_IMAD == 264
    assert cost.IMAD_PER_S == pytest.approx(16.72704e12)
    # operations bound: 1e9 products
    assert cost.least_seconds(0, 10 ** 9) == pytest.approx(
        264e9 / cost.IMAD_PER_S)
    # bytes bound
    assert cost.least_seconds(3.35e12, 1) == pytest.approx(1.0)


def test_witness_map_work_by_hand():
    # m = 8: 7 transforms of 4 butterflies x 3 stages, 4 m coset products,
    # m pointwise, plus 10 nonzeros
    n_bytes, products = cost.witness_map_work(8, 10, 5, 4)
    assert products == 10 + 7 * 12 + 32 + 8
    assert n_bytes == 5 * 32 + 10 * 36 + 3 * 4 * 4 + 8 * 32


@pytest.mark.parametrize('c,expect', [
    (1, (1 + 0 + 1 + 2, 3)),     # bits set: 5 -> {0, 2}, 2^253 + 1 -> {0, 253}
    (4, (1 + 2, 2)),             # 5 in window 0; 2^253 + 1 in windows 0, 63
    (8, (1 + 2, 2)),
])
def test_nonzero_digits_by_hand(c, expect):
    w = cost.scalar_words([5, 0, (1 << 253) + 1])
    assert cost.nonzero_digits(w, c) == expect


def test_nonzero_digits_across_words():
    # a 20-bit window straddling bits 60..79 (words 0 and 1)
    v = 1 << 64
    w = cost.scalar_words([v])
    assert cost.nonzero_digits(w, 20) == (1, 1)
    assert cost.nonzero_digits(w, 1) == (1, 1)


def test_uniform_additions_by_hand():
    n = 1 << 16
    best = min(n * -(-254 // c) * (1 - 2.0 ** -c) + -(-254 // c) * 2 ** (c + 1)
               for c in range(1, 25))
    assert cost.msm_additions(uniform=n) == pytest.approx(best)


def test_band_finds_the_fewest_additions():
    """The band around the uniform optimum gives the full scan's count,
    on full-field scalars with zeros and bits mixed in."""
    rng = random.Random(5)
    vals = [rng.getrandbits(254) for _ in range(3000)] + [0] * 500 + \
        [1] * 500
    w = cost.scalar_words(vals)
    full = min(d + k * 2 * (1 << c) for c in cost.WINDOWS
               for d, k in [cost.nonzero_digits(w, c)])
    assert cost.msm_additions(w) == full


def test_msm_work():
    assert cost.msm_work(10, 100, False) == (10 * 96, 600)
    assert cost.msm_work(10, 100, True) == (10 * 160, 1800)
