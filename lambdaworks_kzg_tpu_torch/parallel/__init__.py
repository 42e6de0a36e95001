"""The multi-device tier: a (data, points) mesh of devices and the MSM and
NTT sharded over it (the JAX package's `parallel/`).

`make_mesh` builds the mesh; `EIP4844Context(setup, mesh=...)` (or
`KZGConfig.mesh_shape`, LWKZG_MESH_SHAPE=DxP) runs every MSM of a setup
sharded over it (`ops/backend.TorchBackend`); `ntt.sharded_ntt` runs the
four-step NTT over one axis. One process drives every
device of one host. The JAX package's `parallel/distributed.py` (one
process per host) has no counterpart yet.

Exports resolve lazily (PEP 562), as in the JAX package.
"""

from importlib import import_module

_EXPORTS = {
    "make_mesh": ".mesh",
    "sharded_msm": ".msm",
    "sharded_msm_device": ".msm",
    "batch_msm": ".msm",
    "make_batch_msm_step": ".msm",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(_EXPORTS[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
