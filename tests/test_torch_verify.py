"""The port's verify path against the JAX package, on the CPU.

- the port's hashing, the Fp2/Fp6/Fp12 tower, G2 and the pairing equal
  the JAX host modules on seeded inputs;
- on the 32-point dev setup, `verify_kzg_proof`, `verify_blob_kzg_proof`
  and `verify_blob_kzg_proof_batch` give the JAX host-backend context's
  verdicts on true and false proofs, and raise KZGError where it does;
- every mainnet verify vector that fails its input checks, the empty
  batch, and one true and one false `verify_kzg_proof` vector (those
  need no blob evaluation; the rest run on the card in chip_smoke.py);
- the vector reader equals `yaml` on every file of the six functions."""

import glob
import os
import random
import re

import pytest
import torch
import yaml

from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu.host import field as JF
from lambdaworks_kzg_tpu.host import pairing as JP
from lambdaworks_kzg_tpu.models.eip4844 import KZGError as JaxKZGError
from lambdaworks_kzg_tpu.utils import hashing as JH
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError, convert
from lambdaworks_kzg_tpu_torch.constants import P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.host import field as F
from lambdaworks_kzg_tpu_torch.host import pairing as HP
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.utils import hashing as H
from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case, parse_vector

from .test_torch_prove import FIXEDBASE, N_DEV, dev_contexts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(REPO, "testdata", "consensus")
FUNCTIONS = ("blob_to_kzg_commitment", "compute_kzg_proof", "compute_blob_kzg_proof",
             "verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fr(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _rand_blob(rng, n=N_DEV):
    return b"".join(_fr(rng.randrange(R)) for _ in range(n))


def test_hashing_matches_jax():
    rng = random.Random(71)
    blob, commitment = _rand_blob(rng, 8), bytes([0xC0]) + bytes(47)
    assert H.compute_challenge(blob, commitment, 8) == JH.compute_challenge(blob, commitment, 8)
    zs, ys = [rng.randrange(R) for _ in range(3)], [rng.randrange(R) for _ in range(3)]
    cs = [rng.randbytes(48) for _ in range(3)]
    ps = [rng.randbytes(48) for _ in range(3)]
    assert H.compute_r_powers(cs, zs, ys, ps, 8) == JH.compute_r_powers(cs, zs, ys, ps, 8)
    assert H.compute_powers(zs[0], 5) == JH.compute_powers(zs[0], 5)
    for v in (0, 1, R - 1):
        assert H.bls_field_to_bytes(v) == JH.bls_field_to_bytes(v)
        assert H.bytes_to_bls_field(_fr(v)) == v
    for bad in (_fr(R), b"\xff" * 32, bytes(31)):
        with pytest.raises(ValueError):
            H.bytes_to_bls_field(bad)
        with pytest.raises(ValueError):
            JH.bytes_to_bls_field(bad)


def test_tower_matches_jax():
    rng = random.Random(73)

    def fp2():
        return (rng.randrange(P), rng.randrange(P))

    a2, b2 = fp2(), fp2()
    for name in ("fp2_add", "fp2_sub", "fp2_mul"):
        assert getattr(F, name)(a2, b2) == getattr(JF, name)(a2, b2)
    for name in ("fp2_sqr", "fp2_inv", "fp2_neg", "fp2_conj", "fp2_mul_by_xi", "fp2_sqrt"):
        assert getattr(F, name)(a2) == getattr(JF, name)(a2)
    square = F.fp2_sqr(a2)
    assert F.fp2_sqr(F.fp2_sqrt(square)) == square
    a6, b6 = (fp2(), fp2(), fp2()), (fp2(), fp2(), fp2())
    assert F.fp6_mul(a6, b6) == JF.fp6_mul(a6, b6)
    assert F.fp6_inv(a6) == JF.fp6_inv(a6)
    a12, b12 = (a6, b6), ((fp2(), fp2(), fp2()), a6)
    for name in ("fp12_add", "fp12_sub", "fp12_mul"):
        assert getattr(F, name)(a12, b12) == getattr(JF, name)(a12, b12)
    for name in ("fp12_sqr", "fp12_inv", "fp12_conj", "fp12_frobenius"):
        assert getattr(F, name)(a12) == getattr(JF, name)(a12)
    assert F.fp12_frobenius_n(a12, 2) == JF.fp12_frobenius_n(a12, 2)
    assert F.fp12_pow(a12, 12345) == JF.fp12_pow(a12, 12345)
    assert F.fp12_mul(a12, F.fp12_inv(a12)) == F.FP12_ONE


def test_g2_and_pairing_match_jax():
    rng = random.Random(79)
    k1, k2 = rng.randrange(1, R), rng.randrange(1, R)
    q1 = HC.g2_scalar_mul(HC.G2_GENERATOR, k1)
    want = JHC.point_scalar_mul(JHC.FP2_OPS, JHC.G2_GENERATOR, k1)
    assert HC.g2_to_affine(q1) == JHC.to_affine(JHC.FP2_OPS, want)
    assert HC.g2_in_subgroup(q1)
    data = JHC.compress_g2(q1)
    assert HC.g2_points_eq(HC.decompress_g2(data), q1)
    assert HC.decompress_g2(bytes([0xC0]) + bytes(95)) == HC.G2_INFINITY
    for bad in (data[:95], bytes(96), bytes([0xC0]) + bytes(94) + b"\x01"):
        with pytest.raises(HC.DeserializationError):
            HC.decompress_g2(bad)
    p1 = HC.point_scalar_mul(HC.G1_GENERATOR, k2)
    pairs = [(p1, q1), (HC.point_neg(HC.G1_GENERATOR), HC.g2_scalar_mul(HC.G2_GENERATOR, k1 * k2))]
    assert HP.pairing_batch(pairs[:1]) == JP.pairing_batch(pairs[:1])
    assert HP.pairing_batch(pairs) == F.FP12_ONE  # e(k2 G1, k1 G2) e(-G1, k1 k2 G2)
    assert HP.pairings_verify(p1, q1, HC.G1_GENERATOR, HC.g2_scalar_mul(HC.G2_GENERATOR, k1 * k2))
    assert not HP.pairings_verify(p1, q1, HC.G1_GENERATOR, HC.G2_GENERATOR)


@pytest.fixture(scope="module")
def dev_pair():
    return dev_contexts()


def test_verify_kzg_proof_matches_jax(dev_pair):
    jax_ctx, ctx = dev_pair
    rng = random.Random(83)
    blob = _rand_blob(rng)
    commitment = jax_ctx.blob_to_kzg_commitment(blob)
    z = _fr(rng.randrange(R))
    proof, y = jax_ctx.compute_kzg_proof(blob, z)
    y_wrong = _fr((int.from_bytes(y, "little") + 1) % R)
    for args, want in (((commitment, z, y, proof), True), ((commitment, z, y_wrong, proof), False)):
        assert jax_ctx.verify_kzg_proof(*args) is want
        assert ctx.verify_kzg_proof(*args) is want
    not_on_curve = bytes([0x80]) + bytes(46) + b"\x01"
    for bad in ((not_on_curve, z, y, proof), (commitment, _fr(R), y, proof),
                (commitment, z, _fr(R), proof), (commitment, z, y, proof[:47])):
        with pytest.raises(KZGError):
            ctx.verify_kzg_proof(*bad)
        with pytest.raises(JaxKZGError):
            jax_ctx.verify_kzg_proof(*bad)


def test_verify_blob_kzg_proof_and_batch_match_jax(dev_pair, monkeypatch):
    """With the native tier off, so that the plain batched decompression,
    evaluation and generic MSM run (tests/test_torch_native.py runs the
    same checks on the tier)."""
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    jax_ctx, ctx = dev_pair
    rng = random.Random(89)
    blobs = [_rand_blob(rng), _rand_blob(rng), b"\x00" * (32 * N_DEV)]
    cs = [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    ps = [jax_ctx.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    cases = [
        (ctx.verify_blob_kzg_proof, jax_ctx.verify_blob_kzg_proof, (blobs[0], cs[0], ps[0])),
        (ctx.verify_blob_kzg_proof, jax_ctx.verify_blob_kzg_proof, (blobs[0], cs[0], ps[1])),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch, (blobs, cs, ps)),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch,
         (blobs, cs, [ps[0], ps[2], ps[1]])),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch, ([], [], [])),
    ]
    verdicts = []
    for port_fn, jax_fn, args in cases:
        verdicts.append(port_fn(*args))
        assert verdicts[-1] is jax_fn(*args)
    assert verdicts == [True, False, True, False, True]
    not_on_curve = bytes([0x80]) + bytes(46) + b"\x01"
    bad_blob = blobs[0][:-32] + _fr(R)
    for port_fn, jax_fn, args in (
        (ctx.verify_blob_kzg_proof, jax_ctx.verify_blob_kzg_proof, (bad_blob, cs[0], ps[0])),
        (ctx.verify_blob_kzg_proof, jax_ctx.verify_blob_kzg_proof, (blobs[0][:-1], cs[0], ps[0])),
        (ctx.verify_blob_kzg_proof, jax_ctx.verify_blob_kzg_proof, (blobs[0], cs[0], not_on_curve)),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch, (blobs, cs, ps[:2])),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch,
         (blobs, [cs[0], not_on_curve, cs[2]], ps)),
        (ctx.verify_blob_kzg_proof_batch, jax_ctx.verify_blob_kzg_proof_batch,
         ([blobs[1], bad_blob], cs[:2], ps[:2])),
    ):
        with pytest.raises(KZGError):
            port_fn(*args)
        with pytest.raises(JaxKZGError):
            jax_fn(*args)


def test_verify_needs_the_setups_g2_powers(dev_pair):
    _, ctx = dev_pair
    bare = convert.setup_from_numpy(ctx.setup.lagrange_points, ctx.setup.lagrange_valid)
    bare_ctx = EIP4844Context(bare, backend=ctx.backend)
    infinity = bytes([0xC0]) + bytes(47)
    with pytest.raises(ValueError, match="no G2 powers"):
        bare_ctx.verify_kzg_proof(infinity, _fr(1), _fr(0), infinity)


@pytest.fixture(scope="module")
def mainnet_ctx():
    setup = srs.load_mainnet_setup()
    assert len(setup.g2_monomial) == 65 and len(setup.g1_monomial) == 4096
    backend = TorchBackend(setup, "cpu", fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu"))
    return EIP4844Context(setup, backend=backend)


_CHEAP = re.compile(r"not_in_G1|not_on_curve|too_few_bytes|too_many_bytes|length_different"
                    r"|invalid_(blob|y|z)|batch_case_a271b78b8e869d69"
                    r"|verify_kzg_proof_case_(in)?correct_proof_0b16242de3e9c686$")


def _cheap_cases():
    """Verify vectors that fail their input checks before any blob
    evaluation, the empty batch, and one true and one false
    verify_kzg_proof (a host pairing each)."""
    out = []
    for fn in FUNCTIONS[3:]:
        for name in sorted(os.listdir(os.path.join(VECTORS, fn, "small"))):
            if _CHEAP.search(name):
                out.append(pytest.param(fn, name, id=name))
    return out


@pytest.mark.parametrize("fn, name", _cheap_cases())
def test_mainnet_verify_vector_on_cpu(mainnet_ctx, fn, name):
    case = load_case(os.path.join(VECTORS, fn, "small", name, "data.yaml"))
    inp = case["input"]
    args = {
        "verify_kzg_proof": ("commitment", "z", "y", "proof"),
        "verify_blob_kzg_proof": ("blob", "commitment", "proof"),
        "verify_blob_kzg_proof_batch": ("blobs", "commitments", "proofs"),
    }[fn]
    if case["output"] is None:
        with pytest.raises(KZGError):
            getattr(mainnet_ctx, fn)(*(inp[a] for a in args))
    else:
        assert getattr(mainnet_ctx, fn)(*(inp[a] for a in args)) is case["output"]


def test_vector_reader_matches_yaml():
    paths = sorted(glob.glob(os.path.join(VECTORS, "*", "small", "*", "data.yaml")))
    assert len(paths) == 208
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert parse_vector(text) == yaml.load(text, Loader=loader), path
    for bad in ("input: {blob: 0x12}\noutput: null", "input: {blob: '0x'\noutput: null",
                "input: {blob: '0x'}\noutput: null\nextra: true", "input:\noutput: null"):
        with pytest.raises(ValueError):
            parse_vector(bad)
