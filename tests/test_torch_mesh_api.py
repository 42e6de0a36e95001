"""The port's slice of the multi-device tier as a whole, on the CPU: JAX
`tests/test_mesh_api.py:63-96` at N = 32. A port context whose backend
holds the 32-point dev setup on a logical (2, 4) mesh of the CPU gives
the JAX host-backend context's bytes and verdicts for
`blob_to_kzg_commitment_batch`, `compute_kzg_proof`,
`compute_blob_kzg_proof` and its batch, `verify_kzg_proof`,
`verify_blob_kzg_proof` and `verify_blob_kzg_proof_batch`, true and with
the proofs reversed. Every commitment and proof batch runs on both data
rows and all four point shards, folded by the plain add.

The module's fixtures are those of tests/test_torch_parallel.py: one
torch thread, and the fixed-base tables from the host oracle."""

import random

import torch

from lambdaworks_kzg_tpu_torch import EIP4844Context
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend

from .test_torch_parallel import (_one_torch_thread, _oracle_tables, _rand_blob,  # noqa: F401
                                  cpu_mesh, dev_pair)


def test_entry_points_on_a_mesh_match_jax(dev_pair, monkeypatch):
    """JAX tests/test_mesh_api.py:63-96 at N = 32 on a (2, 4) mesh: three
    blobs (an odd batch: the data axis pads it; a batch verify's linear
    combinations stay below the generic MSM's sharding threshold). The
    native tier is off, so that the batch verification runs the plain
    batched decompression, evaluation and MSM on the mesh's backend."""
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    jax_ctx, plain = dev_pair
    backend = TorchBackend(plain.setup, "cpu", fixedbase=plain.backend.fixedbase(),
                           mesh=cpu_mesh(2, 4))
    assert backend.device == torch.device("cpu") and backend.shards.width == 32 // 4
    ctx = EIP4844Context(plain.setup, backend=backend)
    rng = random.Random(7)
    blobs = [_rand_blob(rng) for _ in range(3)]
    cs = ctx.blob_to_kzg_commitment_batch(blobs)
    assert cs == [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    z = rng.randrange(R).to_bytes(32, "little")
    proof, y = ctx.compute_kzg_proof(blobs[0], z)
    assert (proof, y) == jax_ctx.compute_kzg_proof(blobs[0], z)
    assert ctx.verify_kzg_proof(cs[0], z, y, proof) is jax_ctx.verify_kzg_proof(cs[0], z, y, proof) is True
    bps = [jax_ctx.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    assert ctx.compute_blob_kzg_proof(blobs[0], cs[0]) == bps[0]
    assert ctx.compute_blob_kzg_proof_batch(blobs, cs) == bps
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], bps[0]) is True
    assert jax_ctx.verify_blob_kzg_proof(blobs[0], cs[0], bps[0]) is True
    for proofs, want in ((bps, True), (bps[::-1], False)):
        assert ctx.verify_blob_kzg_proof_batch(blobs, cs, proofs) is want
        assert jax_ctx.verify_blob_kzg_proof_batch(blobs, cs, proofs) is want
