"""K5 ``bucket_fold``'s plain version (ethsnarks_tpu_torch.ops.fold) in the
schedules that cards of several sizes give it, against the exact host sum
sum_b b * S_b of each window from the JAX package's bn254.  The schedules
use blocks of 32 threads where 128 would leave a small window one block,
so that windows split over several blocks and meet the tail; the cases
keep to 512 bucket points."""
import numpy as np
import pytest

from ethsnarks_tpu.bn254 import add, multiply

from ethsnarks_tpu_torch.ops import curve, fold, kernels

from torch_port_helpers import affine, host_points, \
    torch_threads  # noqa: F401


def _host_fold(buckets):
    """sum_b b * S_b by a running sum from the top bucket."""
    run = acc = None
    for S in reversed(buckets[1:]):
        run = add(run, S)
        acc = add(acc, run)
    return acc


def _buckets(n, g2, seed):
    pts = host_points(8, g2) + [None]
    sel = np.random.default_rng(seed).integers(0, len(pts), n)
    host = [pts[i] for i in sel]
    return host, (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(
        host, 'cpu')


# (n_win, c, SMs, blocks an SM, threads a block): the SM and block counts
# of an H100 at K5's occupancy (132 x 3 or 4), of a tiny card (2 x 1), and
# (3 x 1) for parts of 3 buckets (86 parts, 10 empty threads, 3 blocks)
CASES = [(1, 7, 132, 3, 32), (2, 6, 132, 4, 32), (16, 4, 132, 3, 32),
         (1, 7, 2, 1, 32), (2, 7, 2, 1, 32), (16, 4, 2, 1, None),
         (1, 6, 2, 1, 32), (1, 8, 3, 1, 32)]


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
@pytest.mark.parametrize('n_win,c,sms,blocks,threads', CASES,
                         ids=['%dx2^%d-%dx%d-t%s' % case for case in CASES])
def test_bucket_fold_plain_schedules_match_host(g2, n_win, c, sms, blocks,
                                                threads):
    sched = fold.fold_schedule(n_win, c, g2, sms, blocks, threads)
    host, B = _buckets(n_win << c, g2, n_win + c + sms)
    B[3] = B[2]                                 # P + P in the running sums
    host[3] = host[2]
    got = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(
        kernels.bucket_fold(B, n_win, c, g2, sched))
    for w in range(n_win):
        assert affine(got[w]) == affine(_host_fold(host[w << c:
                                                        (w + 1) << c]))


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_fold_tail_plain_two_partials_a_thread(g2):
    """The tail on 64 block partials (r_g, a_g) of 32 threads, two partials
    a thread: sum_g (a_g + g r_g), identities among the r_g."""
    pts = host_points(16, g2)
    r = [None if g % 7 == 0 else pts[g % 16] for g in range(64)]
    a = [pts[(3 * g + 1) % 16] for g in range(64)]
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    got = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(
        fold.fold_tail_plain(conv(r, 'cpu')[None], conv(a, 'cpu')[None], 32,
                             g2))
    want = None
    for g in range(64):
        want = add(want, a[g])
        if r[g] is not None and g:
            want = add(want, multiply(r[g], g))
    assert affine(got[0]) == affine(want)
