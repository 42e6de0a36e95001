"""The port's configuration (the JAX package's `utils/config.py`).

One frozen record of the switches the port honours:

  device_pairing = None    (default) follow the device: a backend on a
                           CUDA device runs the pairing check on the card
                           (`ops/pairing_ops.py`, the kernels of
                           `csrc/pairing.cu`), a CPU backend on the host
                           tier (`host/pairing.py`, Python ints)
  device_pairing = True    the device tier on any backend
  device_pairing = False   the host tier on any backend

  LWKZG_DEVICE_PAIRING=1 sets True; unset or empty leaves None; any
  other value (=0 among them) sets False, as the JAX package reads it.

  mesh_shape = None        (default) one device
  mesh_shape = (D, P)      a (data, points) mesh of D P devices
                           (`parallel/`): every MSM sharded over it,
                           the batch APIs' blobs over its data axis

  LWKZG_MESH_SHAPE=DxP sets (D, P); a malformed value raises ValueError.

The fields keep the JAX package's names; only device_pairing's default
follows the device. The JAX package's other fields (window bits, setup
path, backend) come with the features that read them.
"""

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class KZGConfig:
    """The port's switches, immutable."""

    # the pairing tier: None follows the backend's device, True / False
    # force the device / the host tier
    device_pairing: Optional[bool] = None

    # the device mesh (data, points); None = one device
    mesh_shape: Optional[Tuple[int, int]] = None

    def validate(self) -> "KZGConfig":
        if self.device_pairing is not None and not isinstance(self.device_pairing, bool):
            raise ValueError("device_pairing must be None or a bool")
        if self.mesh_shape is not None:
            d, p = self.mesh_shape
            if d < 1 or p < 1:
                raise ValueError("mesh_shape axes must be >= 1")
        return self

    @staticmethod
    def from_env() -> "KZGConfig":
        """The documented LWKZG_* environment switches."""
        value = os.environ.get("LWKZG_DEVICE_PAIRING", "")
        mesh = os.environ.get("LWKZG_MESH_SHAPE")
        mesh_shape = None
        if mesh:
            try:
                d, p = mesh.lower().split("x")
                mesh_shape = (int(d), int(p))
            except ValueError as e:
                raise ValueError(f"LWKZG_MESH_SHAPE must look like '2x4', got {mesh!r}") from e
        return KZGConfig(device_pairing=value == "1" if value else None,
                         mesh_shape=mesh_shape).validate()

    def make_mesh(self, device="cuda"):
        """The (data, points) mesh this config names over the devices of
        `device`'s type (every CUDA device of the machine, or the one
        CPU), or None. A shape larger than those devices raises."""
        if self.mesh_shape is None:
            return None
        import torch

        from ..parallel.mesh import make_mesh

        device = torch.device(device)
        devices = None if device.type == "cuda" else [device]
        return make_mesh(devices, data=self.mesh_shape[0], points=self.mesh_shape[1])


DEFAULT_CONFIG = KZGConfig().validate()
