"""TorchBackend: the commit, prove and batch-verify paths of one trusted
setup on one device.

Holds the fixed-base table on the device in the accumulation's layout,
built at init by one launch of the `g1_fixedbase_table` kernel (on a CUDA
device; the plain version on the CPU) unless a table is handed in, and
the Fr evaluation domain (`fr_poly.FrDomain`). It commits a batch of
blobs through one `msm.msm_fixedbase_device` call and one transfer of
the results, and opens a batch (proof and y for each blob) through one
batched evaluation, one batched quotient and one such MSM of the
quotients, which stay on the device until the MSM's result comes back.
Batch verification decompresses its points in one batched pass
(`decompress_g1_batch`) and forms its linear combinations with the
generic MSM (`msm`), both on the device.
"""

import numpy as np
import torch

from ..constants import R, num_windows
from ..host import curve as HC
from . import codec, dispatch, fr_poly, g1_batch, g1_ops, msm
from .dispatch import resolve_device
from . import limbs as lb
from .field_ops import FR


GROUPS = 8  # lane groups of the bucket grid, as the JAX DeviceBackend fixes them


def auto_window(n: int) -> int:
    """Window bits by setup size, as the JAX package picks them."""
    if n <= 256:
        return 4
    if n >= 1 << 18:
        return 12
    return 8


class TorchBackend:
    """Commit backend bound to one setup and one device.

    fixedbase: optional (table, valid) tensors in the public layout (for
    instance from `convert.fixedbase_from_npz`); built on the device
    otherwise."""

    def __init__(self, setup, device="cuda", fixedbase=None):
        self.device = resolve_device(device)
        self.setup = setup
        self.n = setup.n
        self.c = auto_window(self.n)
        if fixedbase is None:
            points = lb.as_limb_tensor(setup.lagrange_points, self.device)
            valid = torch.from_numpy(np.array(setup.lagrange_valid, dtype=bool)).to(self.device)
            self._table, self._table_valid = dispatch.fixedbase_table(points, valid, self.c)
        else:
            table, valid = fixedbase
            expected = (2, 24, num_windows(self.c) * self.n)
            if tuple(table.shape) != expected:
                raise ValueError(f"fixed-base table must be {expected}, got {tuple(table.shape)}")
            self._table = dispatch.to_table_layout(table.to(self.device))
            self._table_valid = valid.to(self.device)
        self.domain = fr_poly.FrDomain(self.n, self.device)

    def fixedbase(self):
        """(table [2, 24, W N] int64, valid) in the public layout."""
        return dispatch.from_table_layout(self._table), self._table_valid

    def commit_scalars(self, scalars: torch.Tensor, ops=dispatch):
        """[16, n] plain Fr limbs on the device -> host Jacobian point;
        [B, 16, n] -> a list of B points.

        ops=ops.g1_ops runs the plain versions on this device instead of
        the kernels (the reference the kernels are held against)."""
        table = self._table if ops is dispatch else self.fixedbase()[0]
        return msm.msm_fixedbase(
            table, self._table_valid, scalars, self.c, GROUPS, ops
        )

    def commit(self, evals):
        """Fr ints in evaluation form -> host Jacobian point."""
        return self.commit_scalars(msm.scalars_to_tensor(list(evals), self.device))

    def blob_scalars(self, blobs) -> torch.Tensor:
        """Blobs -> [B, 16, n] plain Fr limbs on the device, in one transfer.
        Every blob is checked first: ValueError on a wrong size or a
        non-canonical element, and on nothing else."""
        stacked = np.stack([codec.blob_to_limbs(bytes(b), self.n) for b in blobs])
        return lb.as_limb_tensor(stacked, self.device)

    def commit_blob(self, blob: bytes):
        """Blob bytes -> host Jacobian point; ValueError on a bad blob."""
        return self.commit_blobs([blob])[0]

    def commit_blobs(self, blobs):
        """Blobs -> host Jacobian points; every blob is checked before the
        batch's one MSM runs."""
        return self.commit_scalars(self.blob_scalars(blobs))

    # -- evaluation and opening (the JAX DeviceBackend's names) ----------------

    def evaluate(self, evals, z: int) -> int:
        """p(z) from evaluation-form Fr ints."""
        return self.domain.evaluate(list(evals), z)

    def quotient(self, evals, z: int, y: int) -> list:
        """Fr ints of q(x) = (p(x) - y) / (x - z) on the domain."""
        q = self.domain.quotient_plain_from_mont(self.domain.mont(list(evals)), z, y)
        return lb.limbs_to_ints(q)

    def open(self, evals, z: int):
        """Evaluation-form Fr ints -> (host Jacobian proof, y = p(z))."""
        y = self.evaluate(evals, z)
        q = self.domain.quotient_plain_from_mont(self.domain.mont(list(evals)), z, y)
        return self.commit_scalars(q), y

    def evaluate_scalars(self, scalars: torch.Tensor, zs) -> list:
        """[B, 16, n] plain limbs on the device, host zs -> B ints, in one
        batched evaluation and one transfer."""
        return self.domain.evaluate_blobs_plain(scalars, zs)

    def evaluate_blobs(self, blobs, zs) -> list:
        return self.evaluate_scalars(self.blob_scalars(blobs), zs)

    def evaluate_blob(self, blob: bytes, z: int) -> int:
        return self.evaluate_blobs([blob], [z])[0]

    def open_scalars(self, scalars: torch.Tensor, zs) -> list:
        """[B, 16, n] plain limbs on the device, host zs -> B (host
        Jacobian proof, y): one batched evaluation, one batched quotient,
        one MSM of the quotients and one wait for the device, which the
        proofs' transfer makes after everything is queued. A batch with a
        z in the domain goes blob by blob (JAX `open_blobs`)."""
        zs = [z % R for z in zs]
        idx = [self.domain.root_index.get(z) for z in zs]
        if any(i is not None for i in idx):
            if len(zs) > 1:
                return [self.open_scalars(scalars[b : b + 1], [z])[0] for b, z in enumerate(zs)]
            return [self._open_in_domain(scalars[0], zs[0], idx[0])]
        z_m, zn1_m = self.domain.z_consts(zs)  # transfers before any work is queued
        evals_m = FR.to_mont(scalars)
        y_m = self.domain.evaluate_mont(evals_m, z_m, zn1_m)
        q = self.domain.quotient_mont(evals_m, y_m, z_m)
        y = FR.from_mont(y_m)[..., 0].T  # [16, B]
        proofs = self.commit_scalars(q)
        return list(zip(proofs, lb.limbs_to_ints(y)))

    def _open_in_domain(self, plain: torch.Tensor, z: int, idx: int):
        """(proof, y) for z = w_idx from plain limbs [16, n]: y is the
        stored element (JAX `open_blob`)."""
        z_inv = self.domain.mont([pow(z, R - 2, R)])
        onehot = torch.arange(self.n, device=self.device) == idx
        q = self.domain.quotient_in_domain_mont(FR.to_mont(plain), onehot, z_inv)
        proof = self.commit_scalars(q)
        return proof, lb.limbs_to_ints(plain[:, idx : idx + 1])[0]

    def open_blobs(self, blobs, zs) -> list:
        """Blobs, host zs -> [(host Jacobian proof, y)]; ValueError on a
        bad blob, before any work."""
        return self.open_scalars(self.blob_scalars(blobs), zs)

    def open_blob(self, blob: bytes, z: int):
        return self.open_blobs([blob], [z])[0]

    # -- batch verification (the JAX DeviceBackend's names) --------------------

    def msm(self, scalars, points_affine, scalar_bits: int = 255):
        """sum_i k_i P_i over host affine points ((x, y) or None) -> host
        Jacobian point, on this device: the generic MSM at the window
        `auto_window` picks for len(points). Scalars are taken mod r;
        ValueError for one at or above 2^scalar_bits after that."""
        points = list(points_affine)
        scalars = list(scalars)
        if len(points) != len(scalars):
            raise ValueError("scalar and point counts differ")
        if not points:
            return HC.INFINITY
        pts, valid = g1_ops.make_points_host(points)
        return msm.msm(lb.as_limb_tensor(pts, self.device),
                       torch.from_numpy(valid).to(self.device),
                       msm.scalars_to_tensor(scalars, self.device),
                       auto_window(len(points)), scalar_bits, GROUPS)

    def decompress_g1_batch(self, compressed) -> list:
        """48-byte compressed points -> host Jacobians, decompressed and
        subgroup-checked in one batched pass on this device; ValueError
        naming the first bad index."""
        compressed = [bytes(b) for b in compressed]
        if not compressed:
            return []
        if any(len(b) != 48 for b in compressed):
            raise ValueError("a compressed G1 point must be 48 bytes")
        pts, is_inf, err = g1_batch.decompress_batch(compressed, device=self.device)
        if err.any():
            raise ValueError(f"bad G1 point at index {int(np.argmax(err))}")
        valid = torch.from_numpy(~is_inf).to(self.device)
        return g1_ops.points_to_host(g1_batch.lift_affine(pts, valid))
