"""KZG verification: the pairing on the host tier (Python ints) or, when
`KZGConfig.device_pairing` is set, on the device pairing tier; the batch
check's linear combinations through the backend's MSM.

The port of `KZG.verify` and `KZG.verify_batch` of the JAX package's
`models/kzg.py`: the scalar multiplications of a single check run on the
host; the pairing check runs on the host (`host/pairing.py`) by default,
or through `ops/pairing_ops.pairings_verify_host_points` on the
backend's device (one launch of each pairing kernel on a card, the plain
versions on the CPU); the batch check's three linear combinations go
through `backend.msm` (the generic MSM on the device, `ops/backend.py`).
"""

from ..constants import R
from ..host import curve as C
from ..host.pairing import pairings_verify
from ..ops import pairing_ops
from ..utils.config import DEFAULT_CONFIG


class KZG:
    """The checks of one setup, from its [1]_2 and [s]_2; `backend`
    supplies `msm(scalars, points_affine)` for the batch check and, for the
    device pairing tier, its `device`."""

    def __init__(self, setup, backend, config=None):
        self.backend = backend
        self.config = config if config is not None else DEFAULT_CONFIG
        g2 = setup.g2_monomial
        self.g2_one = C.g2_from_affine(g2[0]) if len(g2) >= 2 else None
        self.g2_s = C.g2_from_affine(g2[1]) if len(g2) >= 2 else None

    def _g2(self):
        if self.g2_s is None:
            raise ValueError("this setup holds no G2 powers: verification needs [1]_2 and [s]_2")
        return self.g2_one, self.g2_s

    def _pairings_verify(self, a1, a2, b1, b2) -> bool:
        """e(a1, a2) == e(b1, b2) on the tier the config names."""
        if self.config.device_pairing:
            return pairing_ops.pairings_verify_host_points(a1, a2, b1, b2, self.backend.device)
        return pairings_verify(a1, a2, b1, b2)

    def verify(self, commitment, z: int, y: int, proof) -> bool:
        """e(C - [y]G1, [1]_2) == e(proof, [s - z]_2)."""
        g2_one, g2_s = self._g2()
        p_minus_y = C.point_add(commitment, C.point_neg(C.point_scalar_mul(C.G1_GENERATOR, y)))
        x_minus_z = C.g2_add(g2_s, C.g2_neg(C.g2_scalar_mul(C.G2_GENERATOR, z)))
        return self._pairings_verify(p_minus_y, g2_one, proof, x_minus_z)

    def verify_batch(self, commitments, zs, ys, proofs, r_powers) -> bool:
        """The random linear combination check, one pairing:
        e(sum r^i proof_i, [s]_2) == e(sum r^i (C_i - [y_i]G1 + z_i proof_i), [1]_2),
        with sum r^i [y_i]G1 folded into the commitments' combination as
        one more point."""
        g2_one, g2_s = self._g2()
        msm = self.backend.msm
        proof_aff = [C.to_affine(p) for p in proofs]
        commitment_aff = [C.to_affine(c) for c in commitments]
        neg_y_sum = (-sum(r * y for r, y in zip(r_powers, ys))) % R
        proof_lincomb = msm(list(r_powers), proof_aff)
        proof_z_lincomb = msm([r * z % R for r, z in zip(r_powers, zs)], proof_aff)
        c_minus_y_lincomb = msm(list(r_powers) + [neg_y_sum],
                                commitment_aff + [C.to_affine(C.G1_GENERATOR)])
        rhs = C.point_add(c_minus_y_lincomb, proof_z_lincomb)
        return self._pairings_verify(rhs, g2_one, proof_lincomb, g2_s)
