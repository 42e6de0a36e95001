"""lambdaworks_kzg_tpu_torch: the PyTorch + CUDA (Hopper) port of
lambdaworks_kzg_tpu. EIP4844Context serves the seven EIP-4844 entry
points and the batched commit and proof APIs: commitments and proofs
run on the card, through the Fr evaluation and quotient as PyTorch ops
and the fixed-base MSM on hand-written CUDA kernels (ops/kernels.py);
verification runs its pairing check on the card through two more
kernels (on a CPU context, or with KZGConfig(device_pairing=False), on
the host), with batch verification's point decompression and linear
combinations on the card.
A trusted setup without a cached conversion is converted on the card
(load_trusted_setup_file)."""

from .constants import BYTES_PER_BLOB, FIELD_ELEMENTS_PER_BLOB
from .models.eip4844 import EIP4844Context, KZGError
from .models.kzg import KZG
from .models.srs import (
    TrustedSetup,
    create_dev_setup,
    load_mainnet_setup,
    load_trusted_setup_file,
    load_trusted_setup_from_bytes,
)
from .utils.config import DEFAULT_CONFIG, KZGConfig

__all__ = [
    "BYTES_PER_BLOB",
    "FIELD_ELEMENTS_PER_BLOB",
    "DEFAULT_CONFIG",
    "EIP4844Context",
    "KZG",
    "KZGConfig",
    "KZGError",
    "TrustedSetup",
    "create_dev_setup",
    "load_mainnet_setup",
    "load_trusted_setup_file",
    "load_trusted_setup_from_bytes",
]
