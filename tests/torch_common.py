"""Helpers shared by the port's CPU tests: the fixed-base table of a small
setup by the host curve, and a KZG opening under a known secret."""

import torch

from lambdaworks_kzg_tpu_torch.constants import R, num_windows
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.ops import g1_ops, limbs as lb


def host_table(lagrange_aff, c):
    """The fixed-base table from the host oracle ([2^(c w)] P_i by Python
    ints, ~1 s at N = 32), in place of the plain build on the CPU (~5 s),
    which tests/test_torch_commit.py and tests/test_torch_msm.py cover."""
    cols = []
    for pt in lagrange_aff:
        cur, col = HC.from_affine(pt), []
        for _ in range(num_windows(c)):
            col.append(HC.to_affine(cur))
            for _ in range(c):
                cur = HC.point_double(cur)
        cols.append(col)
    table, valid = g1_ops.make_points_host([col[w] for w in range(num_windows(c)) for col in cols])
    return lb.as_limb_tensor(table), torch.from_numpy(valid)


def opening(rng, n, secret):
    """(commitment, z, y, proof) of a random polynomial of degree < n
    under `secret`, by the host curve."""
    coeffs = [rng.randrange(R) for _ in range(n)]

    def p(x):
        return sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R

    z = rng.randrange(R)
    y = p(z)
    q = (p(secret) - y) * pow(secret - z, R - 2, R) % R
    return HC.point_scalar_mul(HC.G1_GENERATOR, p(secret)), z, y, HC.point_scalar_mul(HC.G1_GENERATOR, q)
