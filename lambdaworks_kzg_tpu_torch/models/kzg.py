"""KZG verification: the pairing check on the backend's device (on a card)
or on the host tier (Python ints), as `KZGConfig.device_pairing` says;
the batch check's linear combinations through the backend's MSM.

The port of `KZG.verify` and `KZG.verify_batch` of the JAX package's
`models/kzg.py`: the scalar multiplications of a single check, [y]G1
and [z]G2, run on the host, on the native C++ tier (`native.py`) unless
LWKZG_NATIVE=0 turns it off, on either pairing tier (JAX's device
branch keeps Python ints there, a departure ROADMAP.md records). The pairing
check follows the backend's device by default: on a CUDA device it goes
through `ops/pairing_ops.pairings_verify_host_points` (one launch of each
pairing kernel), on the CPU through the host tier: the native pairing,
or with the tier off `host/pairing.py` (Python ints), both of which beat
the plain PyTorch tower there; `device_pairing=True` or `False` forces
one tier. The batch check's three linear combinations go through one
`backend.msm_batch` call (a batch of generic MSMs on the device,
`ops/backend.py`).
"""

import torch

from .. import native
from ..constants import R
from ..host import curve as C
from ..host.pairing import pairings_verify
from ..ops import pairing_ops
from ..utils.config import DEFAULT_CONFIG


class KZG:
    """The checks of one setup, from its [1]_2 and [s]_2; `backend`
    supplies `msm_batch(scalar_rows, points_affine)` for the batch check
    and its `device`, where the device pairing tier runs."""

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

    def device_pairing(self) -> bool:
        """Whether the pairing check runs on the backend's device: as the
        config says, else where the backend's device is a card."""
        if self.config.device_pairing is not None:
            return self.config.device_pairing
        return torch.device(self.backend.device).type == "cuda"

    def _pairings_verify(self, a1, a2, b1, b2) -> bool:
        """e(a1, a2) == e(b1, b2) on the tier `device_pairing` picks; the
        host tier on the native library when it is on."""
        if self.device_pairing():
            return pairing_ops.pairings_verify_host_points(a1, a2, b1, b2, self.backend.device)
        if native.available():
            return native.pairings_verify_affine(C.to_affine(a1), C.g2_to_affine(a2),
                                                 C.to_affine(b1), C.g2_to_affine(b2))
        return pairings_verify(a1, a2, b1, b2)

    def verify(self, commitment, z: int, y: int, proof) -> bool:
        """e(C - [y]G1, [1]_2) == e(proof, [s - z]_2)."""
        g2_one, g2_s = self._g2()
        if native.available():
            yg = native.g1_scalar_mul_affine(C.to_affine(C.G1_GENERATOR), y % R)
            zg2 = native.g2_scalar_mul_affine(C.g2_to_affine(C.G2_GENERATOR), z % R)
            y_g1 = C.INFINITY if yg is None else C.from_affine(yg)
            z_g2 = C.G2_INFINITY if zg2 is None else C.g2_from_affine(zg2)
        else:
            y_g1 = C.point_scalar_mul(C.G1_GENERATOR, y)
            z_g2 = C.g2_scalar_mul(C.G2_GENERATOR, z)
        p_minus_y = C.point_add(commitment, C.point_neg(y_g1))
        x_minus_z = C.g2_add(g2_s, C.g2_neg(z_g2))
        return self._pairings_verify(p_minus_y, g2_one, proof, x_minus_z)

    def verify_batch(self, commitments, zs, ys, proofs, r_powers) -> bool:
        """The random linear combination check, one pairing:
        e(sum r^i proof_i, [s]_2) == e(sum r^i (C_i - [y_i]G1 + z_i proof_i), [1]_2),
        with sum r^i [y_i]G1 folded into the commitments' combination as
        one more point. The three combinations are one `msm_batch` call over
        [proofs, commitments, G1]: rows r^i and r^i z_i on the proofs, r^i
        on the commitments with -sum r^i y_i on G1, zeros elsewhere (JAX
        makes three `msm` calls; a departure ROADMAP.md records)."""
        g2_one, g2_s = self._g2()
        n = len(proofs)
        zero = [0] * n
        neg_y_sum = (-sum(r * y for r, y in zip(r_powers, ys))) % R
        points = ([C.to_affine(p) for p in proofs] + [C.to_affine(c) for c in commitments]
                  + [C.to_affine(C.G1_GENERATOR)])
        rows = [list(r_powers) + zero + [0],
                [r * z % R for r, z in zip(r_powers, zs)] + zero + [0],
                zero + list(r_powers) + [neg_y_sum]]
        proof_lincomb, proof_z_lincomb, c_minus_y_lincomb = self.backend.msm_batch(rows, points)
        rhs = C.point_add(c_minus_y_lincomb, proof_z_lincomb)
        return self._pairings_verify(rhs, g2_one, proof_lincomb, g2_s)
