"""The port's configuration (the JAX package's `utils/config.py`).

One frozen record of the switches the port honours. Today that is the
device pairing tier:

  LWKZG_DEVICE_PAIRING=1   verification runs its pairing check on the
                           context's device (`ops/pairing_ops.py`, the
                           kernels of `csrc/pairing.cu` on a card)
                           instead of the host tier (`host/pairing.py`)

The JAX package's other fields (window bits, mesh shape, setup path,
backend) come with the features that read them.
"""

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class KZGConfig:
    """The port's switches, immutable."""

    # pairing checks through the device tier instead of the host tier
    device_pairing: bool = False

    def validate(self) -> "KZGConfig":
        if not isinstance(self.device_pairing, bool):
            raise ValueError("device_pairing must be a bool")
        return self

    @staticmethod
    def from_env() -> "KZGConfig":
        """The documented LWKZG_* environment switches."""
        return KZGConfig(device_pairing=os.environ.get("LWKZG_DEVICE_PAIRING") == "1").validate()


DEFAULT_CONFIG = KZGConfig().validate()
