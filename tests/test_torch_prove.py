"""The port's prove path against the JAX package, on the CPU.

- the Fr layer (`ops/fr_poly.py`: batch inversion, barycentric
  evaluation, the quotient in and out of the domain) equals the JAX host
  oracles `host/field.batch_fr_inv`, `host/fft.barycentric_evaluate` and
  `HostBackend.quotient`; the `slow` test holds it equal to the JAX
  `FrDomain`'s jitted kernels (an XLA compile);
- on the 32-point dev setup, carried across with `convert.py`, the
  port's CPU context proves bit for bit as the JAX `EIP4844Context` on
  its host backend: `compute_kzg_proof` at z outside the domain and at
  every root, `compute_blob_kzg_proof(_batch)`, a batch with one z in the
  domain, and the same KZGError on bad input;
- mainnet vectors whose quotient is zero (zero blobs, one with z in the
  domain) and those that fail their checks, through the committed
  fixed-base table. A dense quotient takes ~30 s of plain PyTorch here,
  so the other 46 + 12 run on the card in chip_smoke.py.

A Fermat inversion of one element costs ~0.3 s of small torch ops here,
and each proof makes one or two, so the tests keep their count low."""

import os
import random

import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import fft as JFFT
from lambdaworks_kzg_tpu.host import field as JF
from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.models.eip4844 import EIP4844Context as JaxContext
from lambdaworks_kzg_tpu.models.eip4844 import KZGError as JaxKZGError
from lambdaworks_kzg_tpu.models.kzg import HostBackend
from lambdaworks_kzg_tpu.ops import g1_ops as JG
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError, convert
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import fr_poly, limbs as lb
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend, auto_window
from lambdaworks_kzg_tpu_torch.ops.field_ops import FR
from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

from .torch_common import host_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(REPO, "testdata", "consensus")
FIXEDBASE = os.path.join(REPO, "cache", "fixedbase_62bcf72bba2b37b8_c8.npz")
N_DEV = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_blob(rng, n):
    return b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(n))


def _fr(v: int) -> bytes:
    return v.to_bytes(32, "little")


def dev_contexts():
    """(JAX host-backend context, port CPU context) on one 32-point setup,
    carried across whole (basis, G1 and G2 powers)."""
    jax_setup = JSRS.create_dev_setup(N_DEV, secret=0xC0FFEE)
    points, valid = JG.make_points_host(jax_setup.g1_lagrange_brp)
    setup = convert.setup_from_numpy(np.asarray(points), np.asarray(valid), "dev-32",
                                     jax_setup.g2_monomial, jax_setup.g1_monomial)
    fixedbase = host_table(jax_setup.g1_lagrange_brp, auto_window(N_DEV))
    backend = TorchBackend(setup, "cpu", fixedbase=fixedbase)
    return JaxContext(jax_setup, backend=HostBackend(jax_setup)), EIP4844Context(setup, backend=backend)


@pytest.fixture(scope="module")
def dev_pair():
    return dev_contexts()


def test_fr_layer_matches_jax_host_oracles(dev_pair):
    jax_ctx, ctx = dev_pair
    rng = random.Random(41)
    domain = ctx.backend.domain
    assert domain.roots_brp_ints == JFFT.bit_reversal_permutation(JFFT.fr_roots_of_unity(N_DEV))
    values = [rng.randrange(1, R) for _ in range(14)] + [1, R - 1]
    assert FR.from_mont_host(fr_poly.batch_inv(domain.mont(values))) == JF.batch_fr_inv(values)
    evals = [rng.randrange(R) for _ in range(N_DEV)]
    host = jax_ctx.kzg.backend
    z_out, z_in = rng.randrange(R), domain.roots_brp_ints[5]
    for z in (z_out, z_in):
        y = JFFT.barycentric_evaluate(evals, z, N_DEV)
        assert ctx.backend.evaluate(evals, z) == y
        assert ctx.backend.quotient(evals, z, y) == host.quotient(evals, z, y)
    y = JFFT.barycentric_evaluate(evals, z_out, N_DEV)
    assert fft.barycentric_evaluate(evals, z_out, N_DEV) == y
    assert fft.quotient(evals, z_out, y, N_DEV) == host.quotient(evals, z_out, y)
    with pytest.raises(ValueError):
        fft.quotient(evals, z_in, 0, N_DEV)


def test_pow_fixed_and_inverse_match_python_ints():
    rng = random.Random(43)
    values = [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]
    a = lb.as_limb_tensor(FR.to_mont_host(values))
    assert FR.from_mont_host(FR.inv(a)) == [pow(v, R - 2, R) for v in values]
    assert FR.from_mont_host(FR.pow_fixed(a, 0)) == [1] * len(values)
    assert FR.from_mont_host(FR.pow_fixed(a, 5)) == [pow(v, 5, R) for v in values]


def test_compute_kzg_proof_matches_jax(dev_pair):
    jax_ctx, ctx = dev_pair
    rng = random.Random(47)
    blob = _rand_blob(rng, N_DEV)
    z = rng.randrange(R)
    assert ctx.compute_kzg_proof(blob, _fr(z)) == jax_ctx.compute_kzg_proof(blob, _fr(z))
    bad = [(blob, _fr(R)), (blob, _fr(1)[:31]), (blob[:-32] + _fr(R), _fr(3)), (blob[:-1], _fr(3))]
    for args in bad:
        with pytest.raises(KZGError):
            ctx.compute_kzg_proof(*args)
        with pytest.raises(JaxKZGError):
            jax_ctx.compute_kzg_proof(*args)


def test_compute_kzg_proof_at_every_root_matches_jax(dev_pair):
    """z = w_m takes the in-domain quotient and y = e_m. The quotient of
    every root, in one batched call, equals the JAX host quotient; the
    whole entry point runs at two roots (a proof's plain MSM costs ~1.2 s
    here, and the MSM is held against the host oracle elsewhere)."""
    jax_ctx, ctx = dev_pair
    blob = _rand_blob(random.Random(53), N_DEV)
    domain, host = ctx.backend.domain, jax_ctx.kzg.backend
    roots = domain.roots_brp_ints
    evals = [int.from_bytes(blob[32 * i : 32 * i + 32], "little") for i in range(N_DEV)]
    q = domain.quotient_in_domain(ctx._scalars([blob])[0], list(range(N_DEV)))
    for m, w in enumerate(roots):
        assert lb.limbs_to_ints(q[m]) == host.quotient(evals, w, evals[m])
    for w in (roots[0], roots[-1]):
        assert ctx.compute_kzg_proof(blob, _fr(w)) == jax_ctx.compute_kzg_proof(blob, _fr(w))


def test_compute_blob_kzg_proof_and_batch_match_jax(dev_pair):
    jax_ctx, ctx = dev_pair
    rng = random.Random(59)
    blobs = [_rand_blob(rng, N_DEV), b"\x00" * (32 * N_DEV)]
    commitments = [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    want = [jax_ctx.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    assert ctx.compute_blob_kzg_proof(blobs[0], commitments[0]) == want[0]
    assert ctx.compute_blob_kzg_proof_batch(blobs, commitments) == want
    assert want[1] == bytes([0xC0]) + bytes(47)
    assert ctx.compute_blob_kzg_proof_batch([], []) == jax_ctx.compute_blob_kzg_proof_batch([], []) == []
    assert ctx.blob_to_kzg_commitment_batch([]) == jax_ctx.blob_to_kzg_commitment_batch([]) == []
    not_on_curve = bytes([0x80]) + bytes(46) + b"\x01"
    bad = [
        (blobs[0], not_on_curve),
        (blobs[0], commitments[0][:47]),
        (blobs[0][:-32] + _fr(R), commitments[0]),
        (blobs[0][:-1], commitments[0]),
    ]
    for blob, commitment in bad:
        with pytest.raises(KZGError):
            ctx.compute_blob_kzg_proof(blob, commitment)
        with pytest.raises(JaxKZGError):
            jax_ctx.compute_blob_kzg_proof(blob, commitment)
        with pytest.raises(KZGError):
            ctx.compute_blob_kzg_proof_batch([blobs[1], blob], [commitments[1], commitment])
    with pytest.raises(KZGError):
        ctx.compute_blob_kzg_proof_batch(blobs, commitments[:1])


def test_open_blobs_with_one_z_in_the_domain_matches_jax(dev_pair):
    """A batch holding a root of the domain goes blob by blob; each
    (proof, y) equals the JAX context's open."""
    jax_ctx, ctx = dev_pair
    rng = random.Random(61)
    blobs = [_rand_blob(rng, N_DEV) for _ in range(2)]
    zs = [rng.randrange(R), ctx.backend.domain.roots_brp_ints[9]]
    for (proof, y), blob, z in zip(ctx.backend.open_blobs(blobs, zs), blobs, zs):
        want_proof, want_y = jax_ctx._open(blob, z)
        assert (HC.compress_g1(proof), y) == (HC.compress_g1(want_proof), want_y)


@pytest.fixture(scope="module")
def mainnet_ctx():
    setup = srs.load_mainnet_setup()
    backend = TorchBackend(setup, "cpu", fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu"))
    return EIP4844Context(setup, backend=backend)


@pytest.mark.parametrize(
    "name",
    [
        "valid_blob_0b16242de3e9c686",  # zero blob
        "valid_blob_3c8480508577945f",  # zero blob, z in the domain
        "invalid_blob_1439f2e2cb979d5c",
        "invalid_blob_29416062520abb81",
        "invalid_z_3aecf687ce696db9",
        "invalid_z_91b54120ef0f14ae",
    ],
)
def test_mainnet_compute_kzg_proof_vector_on_cpu(mainnet_ctx, name):
    case = load_case(os.path.join(VECTORS, "compute_kzg_proof", "small",
                                  f"compute_kzg_proof_case_{name}", "data.yaml"))
    blob, z = case["input"]["blob"], case["input"]["z"]
    if case["output"] is None:
        with pytest.raises(KZGError):
            mainnet_ctx.compute_kzg_proof(blob, z)
    else:
        assert list(mainnet_ctx.compute_kzg_proof(blob, z)) == case["output"]


@pytest.mark.parametrize("name", ["invalid_commitment_not_in_G1", "invalid_commitment_not_on_curve"])
def test_mainnet_compute_blob_kzg_proof_vector_on_cpu(mainnet_ctx, name):
    case = load_case(os.path.join(VECTORS, "compute_blob_kzg_proof", "small",
                                  f"compute_blob_kzg_proof_case_{name}", "data.yaml"))
    assert case["output"] is None
    with pytest.raises(KZGError):
        mainnet_ctx.compute_blob_kzg_proof(case["input"]["blob"], case["input"]["commitment"])


@pytest.mark.slow
def test_fr_poly_matches_jax_fr_domain_kernels():
    """The port's evaluation and quotients against the JAX FrDomain's
    jitted kernels at n = 32 (an XLA compile, hence slow)."""
    import jax.numpy as jnp

    from lambdaworks_kzg_tpu.ops import fr_poly as JFP

    rng = random.Random(67)
    jd, d = JFP.FrDomain(N_DEV), fr_poly.FrDomain(N_DEV, device="cpu")
    plain = np.stack([lb.ints_to_limbs([rng.randrange(R) for _ in range(N_DEV)], 16) for _ in range(2)])
    zs = [rng.randrange(R), d.roots_brp_ints[4]]
    assert d.evaluate_blobs_plain(lb.as_limb_tensor(plain), zs) == jd.evaluate_blobs_plain(plain, zs)
    evals = [lb.limbs_to_ints(plain[0])][0]
    for z in zs:
        y = jd.evaluate(evals, z)
        got = d.quotient(lb.as_limb_tensor(plain[0]), z, y)
        want = jd.quotient_plain_from_mont(jnp.asarray(FR.to_mont_host(evals)), z, y)
        assert np.array_equal(got.numpy(), np.asarray(want))
