"""Card limits and operation counts behind the port's bounds: the least
time an NVIDIA H100 SXM could take for a kernel's work, and the latency
floor of a serial chain of point steps.

Card limits (NVIDIA H100 SXM data sheet): 3.35 TB/s of HBM; 32-bit integer
multiply-adds at 64 lanes per SM per clock (half the 128 float32 lanes
behind the 67 TFLOP/s float32 rate) x 132 SMs x 1.98 GHz = 16.7e12
IMAD/s.  A 32 x 32 -> 64-bit product counts as two IMADs, a low 32-bit
product as one (``python -m ethsnarks_tpu_torch.probe`` measures both
rates).  The rates assume the card's full 700 W power limit.
"""

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9
# 8x8-word CIOS Montgomery product (csrc/field.cuh): 64 wide products of
# the operands, 8 low products m = t[0] * q', 64 wide products m * q[j].
# A squaring needs 36 wide operand products (28 off-diagonal, doubled, and
# 8 diagonal).
FQ_MUL_IMAD = 2 * 64 + 8 + 2 * 64
FQ_SQR_IMAD = 2 * 36 + 8 + 2 * 64
# IMADs per point op, RCB15 algorithms 7 and 9 (csrc/curve.cuh).  G1: 12
# products per add; 6 products and the squarings Y^2, Z^2 per double (3b = 9
# is additions).  G2: an Fq2 product is 3 Fq products (Karatsuba), an Fq2
# squaring 2 (complex squaring); 14 Fq2 products per add (with the two 3b
# products), 7 products and 2 squarings per double.
OP_IMAD = {("add", False): 12 * FQ_MUL_IMAD,
           ("double", False): 6 * FQ_MUL_IMAD + 2 * FQ_SQR_IMAD,
           ("add", True): 14 * 3 * FQ_MUL_IMAD,
           ("double", True): (7 * 3 + 2 * 2) * FQ_MUL_IMAD}


def point_bytes(g2):
    return 192 if g2 else 96


def bound_ms(n_bytes, n_imad):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the HBM
    rate and the IMADs over the IMAD rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imad / IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def msm_imad(n, n_windows, c, g2=False):
    """IMADs of the point operations a Pippenger MSM of n points needs at
    least: n adds a window into buckets, 2 * 2^c a window for the weighted
    bucket sum, c doubles and one add a window to combine the windows."""
    adds = n_windows * (n + 2 * (1 << c)) + n_windows - 1
    doubles = c * (n_windows - 1)
    return adds * OP_IMAD[("add", g2)] + doubles * OP_IMAD[("double", g2)]


# Levels of dependent Fq products in one team step (csrc/curve.cuh
# team_double / team_add): G1 2 (4 then 4 products a double, 6 then 6 an
# add); G2 3 (the products by 3b are a level of their own).
STEP_LEVELS = {False: 2, True: 3}


def horner_steps(n_win, c):
    """Point steps of one accumulator's window combine (K3): c doubles and
    one add for each window below the top one."""
    return (n_win - 1) * (c + 1)


def latency_floor_ms(steps, g2, t_fq_ms):
    """The least time a serial chain of ``steps`` point steps can take on
    the team step: its levels of products one after another, each one
    dependent Fq product's latency ``t_fq_ms`` (measured on the card by
    K7b ``fq_chain``).  The IMAD bound (:func:`bound_ms`) does not apply
    to a chain, whose products cannot all run at once."""
    return steps * STEP_LEVELS[g2] * t_fq_ms
