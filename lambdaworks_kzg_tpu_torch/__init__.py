"""lambdaworks_kzg_tpu_torch: the PyTorch + CUDA (Hopper) port of
lambdaworks_kzg_tpu. This slice commits blobs: EIP4844Context's
blob_to_kzg_commitment and blob_to_kzg_commitment_batch, through the
fixed-base MSM on hand-written CUDA G1 kernels (ops/kernels.py)."""

from .constants import BYTES_PER_BLOB, FIELD_ELEMENTS_PER_BLOB
from .models.eip4844 import EIP4844Context, KZGError
from .models.srs import TrustedSetup, load_mainnet_setup, load_trusted_setup_file

__all__ = [
    "BYTES_PER_BLOB",
    "FIELD_ELEMENTS_PER_BLOB",
    "EIP4844Context",
    "KZGError",
    "TrustedSetup",
    "load_mainnet_setup",
    "load_trusted_setup_file",
]
