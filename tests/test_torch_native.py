"""The port's native C++ tier (`native.py` over its own copy of
`csrc/native/bls12_381.cpp`) against the port's Python-int host oracle and
the JAX package's native tier, on the same seeded inputs; JAX
`tests/test_native.py`'s seven tests, and the port's wiring of the tier:

- the pairing (with infinity operands), the subgroup checks, the G1 and
  G2 scalar multiplications, `g1_decompress` with every rejection class,
  the small MSM with infinity inputs, and `blob_eval` with its
  non-canonical blob and its domain bytes;
- `KZG.verify` and `_check_g1` call the tier (spies), and give the same
  verdicts and rejections with it off (LWKZG_NATIVE=0);
- a CPU backend sends its MSMs, blob evaluations and decompressions up
  to the thresholds to the tier, and a CUDA backend never does;
- `verify_blob_kzg_proof` evaluates its blob on the tier, and the batch
  verification on it gives the JAX host-backend context's verdicts;
- the library loaded lies under the port's `_build/` (the one
  LWKZG_NATIVE_LIB names, when it is set), and a build whose compiler
  fails raises instead of falling back;
- LWKZG_NATIVE_LIB loads the file it names, a path with no file raises,
  and the sanitizer build has a name of its own; the opt-in `slow` test
  runs `scripts/torch_native_asan.py`."""

import copy
import os
import random
import shutil
import subprocess
import sys

import pytest
import torch

from lambdaworks_kzg_tpu import native as jnative
from lambdaworks_kzg_tpu.models.eip4844 import KZGError as JaxKZGError
from lambdaworks_kzg_tpu_torch import KZGError, native
from lambdaworks_kzg_tpu_torch.constants import B_G1, P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.host import fft as FFT
from lambdaworks_kzg_tpu_torch.host.field import fp_sqrt
from lambdaworks_kzg_tpu_torch.host.pairing import pairings_verify
from lambdaworks_kzg_tpu_torch.models import eip4844, srs
from lambdaworks_kzg_tpu_torch.models.kzg import KZG
from lambdaworks_kzg_tpu_torch.ops import backend as backend_module

from .test_torch_prove import N_DEV, dev_contexts
from .torch_common import opening

PKG = os.path.dirname(os.path.abspath(native.__file__))
SECRET = 0x1234


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tier_on(monkeypatch):
    monkeypatch.delenv("LWKZG_NATIVE", raising=False)
    assert native.available()


@pytest.fixture(scope="module")
def kzg8():
    """A KZG of the 8-point dev setup (secret known) over a backend that
    only supplies its device: the CPU, the host pairing tier."""
    setup = srs.create_dev_setup(8, secret=SECRET)

    class _Device:
        device = torch.device("cpu")

    return KZG(setup, _Device())


def _non_subgroup_point(x=2):
    while True:
        y = fp_sqrt((x * x % P * x + B_G1) % P)
        if y is not None and not HC._g1_in_subgroup_py((x, y, 1)):
            return x, y
        x += 1


def test_pairing_matches_oracle(kzg8):
    rng = random.Random(5)
    for trial in range(2):
        commitment, z, y, proof = opening(rng, 8, SECRET)
        p_minus_y = HC.point_add(commitment, HC.point_neg(HC.point_scalar_mul(HC.G1_GENERATOR, y)))
        x_minus_z = HC.g2_add(kzg8.g2_s, HC.g2_neg(HC.g2_scalar_mul(HC.G2_GENERATOR, z)))
        for b2, want in ((x_minus_z, True), (kzg8.g2_s, False)):
            args = (HC.to_affine(p_minus_y), HC.g2_to_affine(kzg8.g2_one), HC.to_affine(proof),
                    HC.g2_to_affine(b2))
            assert pairings_verify(p_minus_y, kzg8.g2_one, proof, b2) is want
            assert native.pairings_verify_affine(*args) is want, trial
            assert jnative.pairings_verify_affine(*args) is want


def test_pairing_with_infinity_operands():
    g = HC.to_affine(HC.G1_GENERATOR)
    g2 = HC.g2_to_affine(HC.G2_GENERATOR)
    assert native.pairings_verify_affine(None, g2, None, g2)
    assert native.pairings_verify_affine(g, g2, g, g2)
    assert not native.pairings_verify_affine(g, g2, None, g2)
    assert not native.pairings_verify_affine(g, None, g, g2)


def test_subgroup_checks_match_oracle():
    g = HC.to_affine(HC.G1_GENERATOR)
    bad = _non_subgroup_point()
    assert native.g1_in_subgroup_affine(g) and HC._g1_in_subgroup_py(HC.G1_GENERATOR)
    assert not native.g1_in_subgroup_affine(bad) and not HC._g1_in_subgroup_py(bad + (1,))
    assert jnative.g1_in_subgroup_affine(bad) is False
    rng = random.Random(9)
    q = HC.g2_scalar_mul(HC.G2_GENERATOR, rng.randrange(1, R))
    assert native.g2_in_subgroup_affine(HC.g2_to_affine(q)) and HC._g2_in_subgroup_py(q)
    # the routed checks agree with the Python ones, on and off the tier
    assert HC.g1_in_subgroup(bad + (1,)) is False and HC.g2_in_subgroup(q) is True


def test_scalar_muls_match_oracle():
    rng = random.Random(6)
    g = HC.to_affine(HC.G1_GENERATOR)
    g2 = HC.g2_to_affine(HC.G2_GENERATOR)
    for k in [rng.randrange(R) for _ in range(3)] + [R - 1, 1]:
        want1 = HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, k))
        want2 = HC.g2_to_affine(HC.g2_scalar_mul(HC.G2_GENERATOR, k))
        assert native.g1_scalar_mul_affine(g, k) == want1 == jnative.g1_scalar_mul_affine(g, k)
        assert native.g2_scalar_mul_affine(g2, k) == want2 == jnative.g2_scalar_mul_affine(g2, k)
    assert native.g1_scalar_mul_affine(g, 0) is None and native.g1_scalar_mul_affine(g, R) is None
    assert native.g2_scalar_mul_affine(g2, 0) is None


def test_kzg_verify_uses_native_and_agrees(kzg8, monkeypatch):
    rng = random.Random(7)
    commitment, z, y, proof = opening(rng, 8, SECRET)
    calls = {}
    for name in ("g1_scalar_mul_affine", "g2_scalar_mul_affine", "pairings_verify_affine"):
        def spy(*args, _fn=getattr(native, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(native, name, spy)
    assert kzg8.verify(commitment, z, y, proof) is True
    assert kzg8.verify(commitment, z, (y + 1) % R, proof) is False
    assert calls == {"g1_scalar_mul_affine": 2, "g2_scalar_mul_affine": 2, "pairings_verify_affine": 2}
    calls.clear()
    # y = 0: [y]G1 is infinity (None) at the tier's boundary; the same
    # opening of p - y
    shifted = HC.point_add(commitment, HC.point_neg(HC.point_scalar_mul(HC.G1_GENERATOR, y)))
    assert kzg8.verify(shifted, z, 0, proof) is True
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    assert not native.available()
    calls.clear()
    assert kzg8.verify(commitment, z, y, proof) is True
    assert kzg8.verify(commitment, z, (y + 1) % R, proof) is False
    assert calls == {}
    assert kzg8.verify(shifted, z, 0, proof) is True


def test_g1_decompress_matches_oracle(monkeypatch):
    rng = random.Random(31)
    for _ in range(6):
        comp = HC.compress_g1(HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R)))
        want = HC.to_affine(HC.decompress_g1(comp))
        assert native.g1_decompress(comp) == want == jnative.g1_decompress(comp)
    assert native.g1_decompress(HC.compress_g1(HC.INFINITY)) is None
    over_p = bytearray(P.to_bytes(48, "big"))
    over_p[0] |= 0x80
    x = 5
    while fp_sqrt((x * x * x + B_G1) % P) is not None:
        x += 1
    off = bytearray(x.to_bytes(48, "big"))
    off[0] |= 0x80
    rx, ry = _non_subgroup_point(3)
    rogue = bytearray(rx.to_bytes(48, "big"))
    rogue[0] |= 0x80 | (0x20 if ry > P - ry else 0)
    cases = [(b"\x00" * 48, "bad encoding"), (b"\xc0" + b"\x01" + b"\x00" * 46, "bad encoding"),
             (bytes(over_p), "x >= p"), (bytes(off), "not on curve"), (bytes(rogue), "not in subgroup")]
    for data, what in cases:
        with pytest.raises(ValueError, match=what):
            native.g1_decompress(data)
        with pytest.raises(ValueError, match=what):
            jnative.g1_decompress(data)
        with pytest.raises(HC.DeserializationError):
            HC.decompress_g1(data)
    assert native.g1_decompress(bytes(rogue), subgroup_check=False) == (rx, ry)
    with pytest.raises(ValueError, match="bad length"):
        native.g1_decompress(bytes(47))
    # _check_g1 takes the tier, maps every class to KZGError, and agrees off it
    calls = []
    real = native.g1_decompress
    monkeypatch.setattr(native, "g1_decompress", lambda *a, **k: calls.append(1) or real(*a, **k))
    good = HC.compress_g1(HC.point_scalar_mul(HC.G1_GENERATOR, 12345))
    on = eip4844._check_g1(good, "commitment")
    for data, _ in cases:
        with pytest.raises(KZGError):
            eip4844._check_g1(data, "commitment")
    assert len(calls) == 1 + len(cases)
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    assert HC.points_eq(eip4844._check_g1(good, "commitment"), on) and len(calls) == 1 + len(cases)
    for data, _ in cases:
        with pytest.raises(KZGError):
            eip4844._check_g1(data, "commitment")


def test_g1_msm_matches_oracle():
    rng = random.Random(32)
    for n in (1, 2, 17, 64, 80):
        scalars = [rng.randrange(R) for _ in range(n)]
        affs = [HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R))) for _ in range(n)]
        if n >= 17:
            affs[3] = None
        want = HC.to_affine(HC.g1_msm(scalars, affs))
        assert native.g1_msm_affine(scalars, affs) == want == jnative.g1_msm_affine(scalars, affs)
    g = HC.to_affine(HC.G1_GENERATOR)
    assert native.g1_msm_affine([0, 0], [g, g]) is None
    assert native.g1_msm_affine([1, R - 1], [g, g]) is None
    assert native.g1_msm_affine([], []) is None
    with pytest.raises(ValueError, match="length"):
        native.g1_msm_affine([1], [g, g])


def test_blob_eval_matches_oracle():
    """Outside and inside the domain, against host/fft's barycentric
    evaluation and the JAX tier; the domain's bytes equal the JAX
    backend's layout (brp roots, 32-byte little-endian)."""
    rng = random.Random(33)
    n = 16
    roots = FFT.bit_reversal_permutation(FFT.fr_roots_of_unity(n))
    roots_le = b"".join(w.to_bytes(32, "little") for w in roots)
    from lambdaworks_kzg_tpu_torch.ops.fr_poly import FrDomain

    assert FrDomain(n, device="cpu").roots_brp_le == roots_le
    evals = [rng.randrange(R) for _ in range(n)]
    blob = b"".join(v.to_bytes(32, "little") for v in evals)
    for z in (rng.randrange(R), roots[5], 0):
        want = FFT.barycentric_evaluate(evals, z, n)
        assert native.blob_eval(blob, roots_le, n, z) == want == jnative.blob_eval(blob, roots_le, n, z)
    bad = blob[:-32] + R.to_bytes(32, "little")
    with pytest.raises(ValueError, match="non-canonical"):
        native.blob_eval(bad, roots_le, n, 3)
    with pytest.raises(ValueError, match="non-canonical"):
        jnative.blob_eval(bad, roots_le, n, 3)
    with pytest.raises(ValueError, match="bytes"):
        native.blob_eval(blob[:-1], roots_le, n, 3)


@pytest.fixture(scope="module")
def dev_pair():
    return dev_contexts()


def test_cpu_backend_routes_small_work_to_native(dev_pair, monkeypatch):
    jax_ctx, ctx = dev_pair
    backend = ctx.backend
    calls = {}
    for name in ("g1_msm_affine", "blob_eval", "g1_decompress"):
        def spy(*args, _fn=getattr(native, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(native, name, spy)
    rng = random.Random(34)
    pts = [HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R))) for _ in range(5)]
    scalars = [rng.randrange(R) for _ in range(5)]
    assert HC.points_eq(backend.msm(scalars, pts), HC.g1_msm(scalars, pts))
    with pytest.raises(ValueError, match="2\\^248"):
        backend.msm([1 << 250], pts[:1], scalar_bits=248)
    comps = [HC.compress_g1(HC.from_affine(pt)) for pt in pts]
    got = backend.decompress_g1_batch(comps + [HC.compress_g1(HC.INFINITY)])
    assert [HC.to_affine(pt) for pt in got] == pts + [None]
    not_on_curve = bytes([0x80]) + bytes(46) + b"\x01"
    with pytest.raises(ValueError, match="bad G1 point at index 1: not on curve"):
        backend.decompress_g1_batch([comps[0], not_on_curve])
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(N_DEV)) for _ in range(2)]
    zs = [rng.randrange(R) for _ in range(2)]
    assert backend.evaluate_blobs(blobs, zs) == [
        FFT.barycentric_evaluate([int.from_bytes(b[32 * i:32 * i + 32], "little") for i in range(N_DEV)],
                                 z, N_DEV) for b, z in zip(blobs, zs)]
    assert calls == {"g1_msm_affine": 1, "g1_decompress": 8, "blob_eval": 2}
    # the thresholds, and a backend on a card never
    limits = (backend_module.NATIVE_MSM_MAX, backend_module.NATIVE_EVAL_MAX,
              backend_module.NATIVE_DECOMPRESS_MAX)
    assert limits == (2048, 256, 4096)
    assert all(backend._native(k, k) and not backend._native(k + 1, k) for k in limits)
    on_card = copy.copy(backend)
    on_card.device = torch.device("cuda")
    assert not any(on_card._native(1, k) for k in limits)
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    assert not backend._native(1, 2048)


def test_verify_blob_paths_on_native_match_jax(dev_pair, monkeypatch):
    """verify_blob_kzg_proof evaluates its blob by native.blob_eval; the
    batch verification (its decompressions, evaluations and MSMs on the
    tier) gives the JAX host-backend context's verdicts and rejections."""
    jax_ctx, ctx = dev_pair
    rng = random.Random(89)
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(N_DEV)) for _ in range(3)]
    cs = [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    ps = [jax_ctx.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, cs)]
    evals = []
    real = native.blob_eval
    monkeypatch.setattr(native, "blob_eval", lambda *a: evals.append(1) or real(*a))
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], ps[0]) is True
    assert ctx.verify_blob_kzg_proof(blobs[0], cs[0], ps[1]) is False
    assert len(evals) == 2
    for args, want in (((blobs, cs, ps), True), ((blobs, cs, [ps[0], ps[2], ps[1]]), False)):
        assert ctx.verify_blob_kzg_proof_batch(*args) is want
        assert jax_ctx.verify_blob_kzg_proof_batch(*args) is want
    bad_blob = blobs[0][:-32] + R.to_bytes(32, "little")
    for fn, args in (("verify_blob_kzg_proof", (bad_blob, cs[0], ps[0])),
                     ("verify_blob_kzg_proof_batch", ([blobs[1], bad_blob], cs[:2], ps[:2]))):
        with pytest.raises(KZGError):
            getattr(ctx, fn)(*args)
        with pytest.raises(JaxKZGError):
            getattr(jax_ctx, fn)(*args)


def test_library_is_the_ports_own_build():
    lib = native._load()
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.join(os.path.realpath(PKG), "_build") + os.sep)
    assert os.path.basename(path).startswith("libbls12381_native_")
    assert path == os.path.realpath(os.environ.get("LWKZG_NATIVE_LIB") or native.library_path())
    assert native.build()["built"] is False


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="LWKZG_NATIVE=0"):
        native.build(str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not build"):
        native.build(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith((".so", ".tmp"))]


def test_native_lib_selects_the_library(tmp_path, monkeypatch):
    copied = tmp_path / "libcopy.so"
    shutil.copy(native.build()["library"], copied)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("LWKZG_NATIVE_LIB", str(copied))
    lib = native._load()
    assert lib._name == str(copied) and native.available()
    g = HC.to_affine(HC.G1_GENERATOR)
    assert native.g1_scalar_mul_affine(g, 5) == HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, 5))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("LWKZG_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="names no file"):
        native.available()
    (tmp_path / "junk.so").write_bytes(b"not a library")
    monkeypatch.setenv("LWKZG_NATIVE_LIB", str(tmp_path / "junk.so"))
    with pytest.raises(RuntimeError, match="did not load"):
        native._load()
    assert native._lib is None


def test_sanitizer_build_has_its_own_name():
    plain, asan = native.library_path(), native.library_path(flags=native.ASAN_CXXFLAGS)
    assert plain != asan and os.path.dirname(plain) == os.path.dirname(asan)
    assert "-fsanitize=address,undefined" in native.ASAN_CXXFLAGS and "-O1" in native.ASAN_CXXFLAGS


@pytest.mark.slow
def test_native_tests_pass_under_asan():
    script = os.path.join(os.path.dirname(PKG), "scripts", "torch_native_asan.py")
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
