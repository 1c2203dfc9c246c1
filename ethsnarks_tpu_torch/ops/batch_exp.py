"""Fixed-base batch multiplication of the Groth16 setup (counterpart of
``ethsnarks_tpu/ops/batch_exp.py``).

The window table of the base stays as the reference builds it, on the
host (``_host_table``, :28-40: entry w*2^c + d = d * 2^(c*w) * base, 8,192
points at c = 8), and is uploaded once.  A batch of scalars is one K4
``fixed_base_mul`` launch (:mod:`.kernels`) that returns projective points
on the device, whatever the batch's size: the reference's 2^16-scalar
chunks, 128-lane padding and host path for batches of at most 256 scalars
(:193-215) exist for the TPU's jit shapes and have no counterpart here.
"""

import torch

from .. import resolve_device
from ..bn254 import add, multiply
from ..field import SNARK_SCALAR_FIELD
from . import curve, kernels
from .fp import ints_to_words_np

R = SNARK_SCALAR_FIELD
C = 8                                    # window bits
N_WIN = -(-254 // C)                     # scalars are below r < 2^254


def host_table(base, c, n_win):
    """[None, base, 2 base, .., (2^c - 1) base, None, 2^c base, ..]: the
    reference's flattened window table as host affine points."""
    rows, cur = [], base
    for _ in range(n_win):
        acc = None
        rows.append(None)
        for _ in range((1 << c) - 1):
            acc = add(acc, cur)
            rows.append(acc)
        cur = add(acc, cur)                      # cur * 2^c
    return rows


class BatchExp(object):
    """Reusable fixed-base multiplier for one G1 or G2 base point."""

    def __init__(self, base, g2=False, device=None):
        self.base = base
        self.g2 = g2
        self.device = resolve_device(device)
        to_tensor = curve.g2_to_tensor if g2 else curve.g1_to_tensor
        self.table = to_tensor(host_table(base, C, N_WIN), self.device)

    def mul(self, scalar):
        """One host multiple: affine point, None for a zero scalar."""
        return multiply(self.base, int(scalar) % R)

    def mul_many(self, scalars):
        """[s_i] -> (n, *point) projective Montgomery words on the device,
        s_i * base (the identity (0, 1, 0) for s_i = 0)."""
        words = torch.from_numpy(
            ints_to_words_np([int(s) % R for s in scalars])).to(self.device)
        return kernels.fixed_base_mul(self.table, words, N_WIN, C, self.g2)
