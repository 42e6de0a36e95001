"""The port's configuration (the JAX package's `utils/config.py`).

One frozen record of the switches the port honours. Today that is the
pairing tier of verification:

  device_pairing = None    (default) follow the device: a backend on a
                           CUDA device runs the pairing check on the card
                           (`ops/pairing_ops.py`, the kernels of
                           `csrc/pairing.cu`), a CPU backend on the host
                           tier (`host/pairing.py`, Python ints)
  device_pairing = True    the device tier on any backend
  device_pairing = False   the host tier on any backend

  LWKZG_DEVICE_PAIRING=1 sets True; unset or empty leaves None; any
  other value (=0 among them) sets False, as the JAX package reads it.

The field keeps the JAX package's name; only its default follows the
device. The JAX package's other fields (window bits, mesh shape, setup
path, backend) come with the features that read them.
"""

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KZGConfig:
    """The port's switches, immutable."""

    # the pairing tier: None follows the backend's device, True / False
    # force the device / the host tier
    device_pairing: Optional[bool] = None

    def validate(self) -> "KZGConfig":
        if self.device_pairing is not None and not isinstance(self.device_pairing, bool):
            raise ValueError("device_pairing must be None or a bool")
        return self

    @staticmethod
    def from_env() -> "KZGConfig":
        """The documented LWKZG_* environment switches."""
        value = os.environ.get("LWKZG_DEVICE_PAIRING", "")
        return KZGConfig(device_pairing=value == "1" if value else None).validate()


DEFAULT_CONFIG = KZGConfig().validate()
