"""TorchBackend: the commit path of one trusted setup on one device.

Holds the fixed-base table on the device in the accumulation's layout,
built at init by one launch of the `g1_fixedbase_table` kernel (on a CUDA
device; the plain version on the CPU) unless a table is handed in, and
commits a batch of blobs through one
`msm.msm_fixedbase_device` call and one transfer of the results.
"""

import numpy as np
import torch

from ..constants import num_windows
from . import codec, dispatch, msm
from . import limbs as lb


def resolve_device(device) -> torch.device:
    """A torch.device; CUDA that is not there raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device


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
