"""Window sums that drive the generic MSM's combine (`ops/g1_ops.py`
`combine_windows`, the plain version of the kernel g1_window_combine)
through each of its exceptional adds: an operand at infinity, equal
operands (the doubling branch) and opposite ones (a sum at infinity), in
a run's Horner chain, in the comb of the runs' sums and in its last add.
The CPU tests and `chip_smoke.py` hold the kernel and its plain version
on them; the scalars are built and checked with Python ints (the host
curve), so the sums are exact whatever the schedule gives.
"""

import random

import numpy as np
import torch

from ..constants import R
from ..host import curve as HC
from ..ops import g1_ops, limbs as lb
from ..ops.field_ops import FP


def combine_edge_scalars(c: int, windows: int, seed: int) -> list:
    """Three MSMs' window scalars s_w (their sums S_w = [s_w] G) that drive
    `combine_windows` through its exceptional adds: MSM 0 a
    Horner add of a window at infinity (run 0's bottom window), a run at
    infinity (run G - 2) and a last add of opposite points (its sum
    infinity); MSM 1 a Horner add of opposite points (run 0: a window
    opposite the doubled accumulator), a comb add and the last add of
    equal points (the doubling branch); MSM 2 a Horner add of equal points
    (run 0), a comb add of opposite points (a partial sum at infinity that
    the next add meets) and the top run's top window at infinity. Parts
    whose runs or windows a shape lacks are left out."""
    rng = random.Random(seed)
    lo = g1_ops.combine_runs(windows, c)
    runs = len(lo)
    top = [x - 1 for x in lo[1:]] + [windows - 1]
    weight = [pow(2, c * w, R) for w in range(windows)]

    def partial(s, j):  # P_j = D_0 + .. + D_j as a scalar
        return sum(s[w] * weight[w] for w in range(top[j] + 1)) % R

    def solve(s, j, target):  # run j's bottom window such that D_j = target
        rest = sum(s[w] * weight[w] for w in range(lo[j] + 1, top[j] + 1))
        s[lo[j]] = (target - rest) * pow(weight[lo[j]], -1, R) % R

    mid = runs - 2  # the comb add below the last, where there is one
    out = []
    for b in range(3):
        s = [rng.randrange(1, R) for _ in range(windows)]
        if b == 0:
            s[lo[0]] = 0
            for w in range(lo[mid], top[mid] + 1) if mid >= 1 else ():
                s[w] = 0
        if b in (1, 2) and top[0] > 0:
            s[top[0] - 1] = (1 if b == 2 else -1) * s[top[0]] * pow(2, c, R) % R
        if b == 2:
            s[top[-1]] = 0
        if b in (1, 2) and mid >= 1:
            solve(s, mid, (1 if b == 1 else -1) * partial(s, mid - 1))
        if b in (0, 1) and runs > 1:
            solve(s, runs - 1, (1 if b == 1 else -1) * partial(s, runs - 2))
        out.append(s)
    return out


def combine_edge_sums(c: int, windows: int, seed: int, device="cpu") -> torch.Tensor:
    """`combine_edge_scalars`' window sums [3, L, 3 W] (MSM b's window w
    at lane b W + w), Jacobian with a random Z != 1 on each finite lane;
    infinity all zeros."""
    rng = random.Random(seed)
    coords = [[], [], []]
    for s in (k for msm in combine_edge_scalars(c, windows, seed) for k in msm):
        aff = HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, s))
        if aff is None:
            x = y = z = 0
        else:
            z = rng.randrange(2, FP.modulus)
            x, y = aff[0] * z * z % FP.modulus, aff[1] * pow(z, 3, FP.modulus) % FP.modulus
        for coord, v in zip(coords, (x, y, z)):
            coord.append(v)
    return lb.as_limb_tensor(np.stack([FP.to_mont_host(v) for v in coords]), device)
