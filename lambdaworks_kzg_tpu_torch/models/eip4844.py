"""EIP-4844 entry points of the port: blob_to_kzg_commitment and its
batched form. The other entry points (compute_kzg_proof,
compute_blob_kzg_proof, verify_kzg_proof, verify_blob_kzg_proof,
verify_blob_kzg_proof_batch) are later slices."""

from typing import List, Optional, Sequence

from ..host import curve as C
from ..ops.backend import TorchBackend
from .srs import TrustedSetup, load_mainnet_setup


class KZGError(ValueError):
    """Invalid input (a wrong-size or non-canonical blob)."""


class EIP4844Context:
    """A setup bound to a device. device defaults to "cuda" and raises
    when CUDA is absent; pass device="cpu" for the plain versions.
    backend: a ready TorchBackend (for instance one given a table)."""

    def __init__(self, setup: Optional[TrustedSetup] = None, device="cuda",
                 backend=None):
        self.setup = setup if setup is not None else load_mainnet_setup()
        self.backend = backend if backend is not None else TorchBackend(self.setup, device)
        self.n = self.setup.n

    def _scalars(self, blobs):
        """Only the blob checks map to KZGError; a fault further down (a
        kernel wrapper's layout check, a launch) raises as it is."""
        try:
            return self.backend.blob_scalars(blobs)
        except ValueError as e:
            raise KZGError(str(e)) from e

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return self.blob_to_kzg_commitment_batch([blob])[0]

    def blob_to_kzg_commitment_batch(self, blobs: Sequence[bytes]) -> List[bytes]:
        scalars = self._scalars(blobs)
        return [C.compress_g1(pt) for pt in self.backend.commit_scalars(scalars)]
