"""The EIP-4844 entry points of the port: the JAX package's seven
(`blob_to_kzg_commitment`, `compute_kzg_proof`, `compute_blob_kzg_proof`,
`verify_kzg_proof`, `verify_blob_kzg_proof`, `verify_blob_kzg_proof_batch`;
the setup loaders are in `models/srs.py`) and the batched
`blob_to_kzg_commitment_batch` and `compute_blob_kzg_proof_batch`.

Commitments and proofs run on the context's device: the Fr evaluation
and quotient as PyTorch ops, the fixed-base MSM on the Hopper kernels
(`ops/backend.py`); on a mesh (`mesh=`, or LWKZG_MESH_SHAPE=DxP) every
MSM is sharded over its devices and the rest runs on its lead device.
Verification runs its pairing check on the context's device when that
is a card, and on the host tier when it is the CPU (`models/kzg.py`);
`KZGConfig.device_pairing` (or LWKZG_DEVICE_PAIRING=1 / 0) forces one
tier. Its blob evaluations run on the device.
`verify_blob_kzg_proof_batch` decompresses and subgroup-checks its 2n
points in one batched pass and forms its three linear combinations with
the generic MSM, both on the device, as the JAX device branch does; the
single checks decompress their points on the host.
"""

from typing import List, Optional, Sequence, Tuple

from ..constants import BYTES_PER_FIELD_ELEMENT
from ..host import curve as C
from ..ops.backend import TorchBackend
from ..utils import hashing as H
from ..utils.config import KZGConfig
from .kzg import KZG
from .srs import TrustedSetup, load_mainnet_setup


class KZGError(ValueError):
    """Invalid input: a wrong-size or non-canonical blob or field element,
    a bad point encoding, a point off the curve or outside its subgroup,
    or lists of different lengths."""


def _check_g1(data: bytes, what: str):
    if len(data) != 48:
        raise KZGError(f"{what} must be 48 bytes")
    try:
        return C.decompress_g1(bytes(data), subgroup_check=True)
    except C.DeserializationError as e:
        raise KZGError(f"bad {what}: {e}") from e


def _check_fr(data: bytes, what: str) -> int:
    if len(data) != 32:
        raise KZGError(f"{what} must be 32 bytes")
    try:
        return H.bytes_to_bls_field(bytes(data))
    except ValueError as e:
        raise KZGError(f"bad {what}: {e}") from e


class EIP4844Context:
    """A setup bound to a device, or to a mesh of devices. device defaults
    to "cuda" and raises when CUDA is absent; pass device="cpu" for the
    plain versions. backend: a ready TorchBackend (for instance one given
    a table). config: a KZGConfig; None reads the environment
    (`KZGConfig.from_env`). mesh: a (data, points) `parallel.mesh.Mesh`
    that every MSM is sharded over (`parallel/`); without a backend and a
    mesh, `config.mesh_shape` (LWKZG_MESH_SHAPE=DxP) names one over the
    devices of `device`'s type. A backend and a mesh together raise: give
    the backend its mesh."""

    def __init__(self, setup: Optional[TrustedSetup] = None, device="cuda",
                 backend=None, config: Optional[KZGConfig] = None, mesh=None):
        self.setup = setup if setup is not None else load_mainnet_setup()
        self.config = (config if config is not None else KZGConfig.from_env()).validate()
        if backend is None:
            if mesh is None:
                mesh = self.config.make_mesh(device)
            backend = TorchBackend(self.setup, device, mesh=mesh)
        elif mesh is not None:
            raise ValueError("pass the mesh to the backend (TorchBackend(setup, mesh=...)), not both")
        self.backend = backend
        self.kzg = KZG(self.setup, self.backend, self.config)
        self.n = self.setup.n

    def _scalars(self, blobs):
        """Blobs -> plain limbs on the device. Only the input checks map
        to KZGError; a fault further down (a kernel wrapper's layout
        check, a launch) raises as it is."""
        try:
            return self.backend.blob_scalars(blobs)
        except ValueError as e:
            raise KZGError(str(e)) from e

    def _check_blob_size(self, blob: bytes) -> None:
        if len(blob) != self.n * BYTES_PER_FIELD_ELEMENT:
            raise KZGError(f"blob must be {self.n * BYTES_PER_FIELD_ELEMENT} bytes")

    def _open(self, blobs, zs):
        """-> [(host Jacobian proof, y)], one batch on the device."""
        return self.backend.open_scalars(self._scalars(blobs), zs)

    # -- commit and prove ---------------------------------------------------------

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return self.blob_to_kzg_commitment_batch([blob])[0]

    def blob_to_kzg_commitment_batch(self, blobs: Sequence[bytes]) -> List[bytes]:
        if not blobs:
            return []
        scalars = self._scalars(blobs)
        return [C.compress_g1(pt) for pt in self.backend.commit_scalars(scalars)]

    def compute_kzg_proof(self, blob: bytes, z_bytes: bytes) -> Tuple[bytes, bytes]:
        z = _check_fr(z_bytes, "z")
        (proof, y), = self._open([blob], [z])
        return C.compress_g1(proof), H.bls_field_to_bytes(y)

    def compute_blob_kzg_proof(self, blob: bytes, commitment_bytes: bytes) -> bytes:
        return self.compute_blob_kzg_proof_batch([blob], [commitment_bytes])[0]

    def compute_blob_kzg_proof_batch(self, blobs: Sequence[bytes],
                                     commitment_bytes_list: Sequence[bytes]) -> List[bytes]:
        """Every commitment is checked before anything else (reference
        lib.rs:373), then every blob's proof at its challenge comes from
        one batch on the device."""
        if len(commitment_bytes_list) != len(blobs):
            raise KZGError("length mismatch")
        for blob in blobs:
            self._check_blob_size(blob)
        for cb in commitment_bytes_list:
            _check_g1(cb, "commitment")
        if not blobs:
            return []
        zs = [H.compute_challenge(bytes(b), bytes(cb), self.n)
              for b, cb in zip(blobs, commitment_bytes_list)]
        return [C.compress_g1(proof) for proof, _ in self._open(blobs, zs)]

    # -- verify --------------------------------------------------------------------

    def verify_kzg_proof(self, commitment_bytes: bytes, z_bytes: bytes, y_bytes: bytes,
                         proof_bytes: bytes) -> bool:
        commitment = _check_g1(commitment_bytes, "commitment")
        z = _check_fr(z_bytes, "z")
        y = _check_fr(y_bytes, "y")
        proof = _check_g1(proof_bytes, "proof")
        return self.kzg.verify(commitment, z, y, proof)

    def verify_blob_kzg_proof(self, blob: bytes, commitment_bytes: bytes,
                              proof_bytes: bytes) -> bool:
        self._check_blob_size(blob)
        commitment = _check_g1(commitment_bytes, "commitment")
        proof = _check_g1(proof_bytes, "proof")
        z = H.compute_challenge(bytes(blob), bytes(commitment_bytes), self.n)
        y = self.backend.evaluate_scalars(self._scalars([blob]), [z])[0]
        return self.kzg.verify(commitment, z, y, proof)

    def verify_blob_kzg_proof_batch(self, blobs: Sequence[bytes],
                                    commitment_bytes_list: Sequence[bytes],
                                    proof_bytes_list: Sequence[bytes]) -> bool:
        """True for an empty batch, as the spec has it (the reference
        library returns false there, lib.rs:537-543)."""
        n = len(blobs)
        if len(commitment_bytes_list) != n or len(proof_bytes_list) != n:
            raise KZGError("length mismatch")
        if n == 0:
            return True
        if n == 1:
            return self.verify_blob_kzg_proof(blobs[0], commitment_bytes_list[0],
                                              proof_bytes_list[0])
        for blob in blobs:
            self._check_blob_size(blob)
        c_list = [bytes(c) for c in commitment_bytes_list]
        p_list = [bytes(p) for p in proof_bytes_list]
        try:  # one batched decompression and subgroup check of all 2n points
            points = self.backend.decompress_g1_batch(c_list + p_list)
        except ValueError as e:
            raise KZGError(str(e)) from e
        commitments, proofs = points[:n], points[n:]
        zs = [H.compute_challenge(bytes(b), c, self.n) for b, c in zip(blobs, c_list)]
        ys = self.backend.evaluate_scalars(self._scalars(blobs), zs)
        r_powers = H.compute_r_powers(c_list, zs, ys, p_list, self.n)
        return self.kzg.verify_batch(commitments, zs, ys, proofs, r_powers)
