"""The port's C ABI (`lambdaworks_kzg_tpu_torch/capi`) against the JAX
package's, on the CPU.

The port's library is built with `capi.build()` and driven through
ctypes, its contexts on the CPU (LWKZG_BACKEND=host, set for this module
only: a module-level environment write leaks into later modules, as
tests/test_capi.py records). The reference is the JAX package's
`capi_adapter`, called directly on its host backend: the same
(return code, payload) pairs its own shim unpacks. On the degree-4 setup
(`testdata/trusted_setup_4.txt`, converted on the CPU into a temporary
cache) the same seeded inputs give the same return code and, where it is
C_KZG_OK, the same bytes (tolerance: byte equality) for
- load_trusted_setup_file (and the blst G1 / G2 tables of KZGSettings),
  load_trusted_setup on good points with wrong counts and on bad points,
  and bad setup files;
- the six compute and verify functions on true and false cases and on
  the BADARGS cases of tests/test_capi.py (a non-canonical element, a
  garbage commitment);
- verify_blob_kzg_proof_batch with n = 0, 1 and 3.
NULL pointers return C_KZG_BADARGS, as the JAX shim returns for a NULL
blob; free_trusted_setup clears KZGSettings and may be repeated.
A batch of three costs ~18 s here (three plain table builds for its
generic MSMs), so it runs once, on a true batch.
"""

import ctypes
import os
import random

import pytest
import torch

from lambdaworks_kzg_tpu import capi_adapter as JA
from lambdaworks_kzg_tpu_torch import capi
from lambdaworks_kzg_tpu_torch.models import srs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")
N = 4
BLOB_SIZE = N * 32
C_KZG_OK, C_KZG_BADARGS = 0, 1
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class KZGSettings(ctypes.Structure):
    _fields_ = [("fs", ctypes.c_void_p), ("g1_values", ctypes.c_void_p),
                ("g2_values", ctypes.c_void_p)]


@pytest.fixture(scope="module", autouse=True)
def _host_env(tmp_path_factory):
    """LWKZG_BACKEND=host and the port's setup cache in a temporary
    directory (so its conversion runs here, on the CPU), for this module
    only; one torch thread."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LWKZG_BACKEND", "host")
    mp.setattr(srs, "CACHE_DIR", str(tmp_path_factory.mktemp("port_setup_cache")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()


@pytest.fixture(scope="module")
def lib():
    lib = ctypes.CDLL(capi.build()["library"])
    for fn in ("load_trusted_setup", "load_trusted_setup_file", "blob_to_kzg_commitment",
               "compute_kzg_proof", "compute_blob_kzg_proof", "verify_kzg_proof",
               "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.free_trusted_setup.restype = None
    return lib


def _load_file(lib, path):
    libc = ctypes.CDLL(None)
    libc.fopen.restype = ctypes.c_void_p
    fp = libc.fopen(path.encode(), b"r")
    assert fp
    s = KZGSettings()
    try:
        ret = lib.load_trusted_setup_file(ctypes.byref(s), ctypes.c_void_p(fp))
    finally:
        libc.fclose(ctypes.c_void_p(fp))
    return ret, s


@pytest.fixture(scope="module")
def settings(lib):
    ret, s = _load_file(lib, SETUP_4)
    assert ret == C_KZG_OK
    yield s
    lib.free_trusted_setup(ctypes.byref(s))
    assert not (s.fs or s.g1_values or s.g2_values)


@pytest.fixture(scope="module")
def jax_ctx():
    ret, ctx = JA.new_context_from_text(open(SETUP_4, "rb").read())
    assert ret == C_KZG_OK
    return ctx


def _blob(seed: int) -> bytes:
    rng = random.Random(seed)
    return b"".join(rng.randrange(2**248).to_bytes(31, "little") + b"\x00" for _ in range(N))


def _port(lib, settings, fn, *args):
    """One call of the port's C function -> (return code, payload or None),
    the payload shaped as the JAX adapter's."""
    s = ctypes.byref(settings)
    if fn in ("verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch"):
        ok = ctypes.c_bool(False)
        ret = getattr(lib, fn)(ctypes.byref(ok), *args, s)
        return ret, (ok.value if ret == C_KZG_OK else None)
    if fn == "compute_kzg_proof":
        proof, y = ctypes.create_string_buffer(48), ctypes.create_string_buffer(32)
        ret = lib.compute_kzg_proof(proof, y, *args, s)
        return ret, (proof.raw + y.raw if ret == C_KZG_OK else None)
    out = ctypes.create_string_buffer(48)
    ret = getattr(lib, fn)(out, *args, s)
    return ret, (out.raw if ret == C_KZG_OK else None)


def _jax(ctx, fn, *args):
    ret, payload = getattr(JA, fn)(ctx, *args)
    return ret, (payload if ret == C_KZG_OK else None)


@pytest.fixture(scope="module")
def inputs(jax_ctx):
    """Seeded blobs, and their commitments and proofs from the JAX side."""
    blob = _blob(1)
    c = JA.blob_to_kzg_commitment(jax_ctx, blob)[1]
    z = (5).to_bytes(32, "little")
    proof_y = JA.compute_kzg_proof(jax_ctx, blob, z)[1]
    blob_proof = JA.compute_blob_kzg_proof(jax_ctx, blob, c)[1]
    batch = [_blob(10 + i) for i in range(3)]
    batch_cs = [JA.blob_to_kzg_commitment(jax_ctx, b)[1] for b in batch]
    batch_ps = [JA.compute_blob_kzg_proof(jax_ctx, b, bc)[1] for b, bc in zip(batch, batch_cs)]
    return {"blob": blob, "c": c, "z": z, "proof": proof_y[:48], "y": proof_y[48:],
            "blob_proof": blob_proof, "batch": (batch, batch_cs, batch_ps)}


def _negated(point: bytes) -> bytes:
    return bytes([point[0] ^ 0x20]) + point[1:]  # the sign bit: -P


GARBAGE = b"\x12" * 48
NON_CANONICAL = b"\xff" * BLOB_SIZE
CASES = {
    "commit": lambda i: ("blob_to_kzg_commitment", i["blob"]),
    "commit zero blob": lambda i: ("blob_to_kzg_commitment", bytes(BLOB_SIZE)),
    "commit non-canonical blob": lambda i: ("blob_to_kzg_commitment", NON_CANONICAL),
    "kzg proof": lambda i: ("compute_kzg_proof", i["blob"], i["z"]),
    "kzg proof at z = r": lambda i: ("compute_kzg_proof", i["blob"], R.to_bytes(32, "little")),
    "kzg proof of non-canonical blob": lambda i: ("compute_kzg_proof", NON_CANONICAL, i["z"]),
    "blob proof": lambda i: ("compute_blob_kzg_proof", i["blob"], i["c"]),
    "blob proof, garbage commitment": lambda i: ("compute_blob_kzg_proof", i["blob"], GARBAGE),
    "verify true": lambda i: ("verify_kzg_proof", i["c"], i["z"], i["y"], i["proof"]),
    "verify false (other y)": lambda i: ("verify_kzg_proof", i["c"], i["z"],
                                         (5).to_bytes(32, "little"), i["proof"]),
    "verify, garbage commitment": lambda i: ("verify_kzg_proof", GARBAGE, i["z"], i["y"], i["proof"]),
    "verify blob true": lambda i: ("verify_blob_kzg_proof", i["blob"], i["c"], i["blob_proof"]),
    "verify blob false (-proof)": lambda i: ("verify_blob_kzg_proof", i["blob"], i["c"],
                                             _negated(i["blob_proof"])),
    "verify blob, garbage points": lambda i: ("verify_blob_kzg_proof", i["blob"], GARBAGE, GARBAGE),
}


@pytest.mark.parametrize("case", list(CASES))
def test_entry_point_matches_jax(lib, settings, jax_ctx, inputs, case):
    fn, *args = CASES[case](inputs)
    want = _jax(jax_ctx, fn, *args)
    assert _port(lib, settings, fn, *args) == want
    if "garbage" in case or "non-canonical" in case or "z = r" in case:
        assert want[0] == C_KZG_BADARGS
    else:
        assert want[0] == C_KZG_OK and ("false" not in case or want[1] is False)


@pytest.mark.parametrize("case", ["n=0", "n=1 true", "n=1 false", "n=3 true"])
def test_batch_verify_matches_jax(lib, settings, jax_ctx, inputs, case):
    blobs, cs, ps = inputs["batch"]
    n = int(case[2])
    blobs, cs, ps = blobs[:n], cs[:n], ps[:n]
    if "false" in case:
        ps = [_negated(ps[0])]
    args = (b"".join(blobs), b"".join(cs), b"".join(ps))
    want = _jax(jax_ctx, "verify_blob_kzg_proof_batch", *args, n)
    assert want == (C_KZG_OK, "false" not in case)
    assert _port(lib, settings, "verify_blob_kzg_proof_batch", *args, ctypes.c_size_t(n)) == want


def test_load_trusted_setup_file_matches_jax(settings, jax_ctx):
    """The blst tables byte for byte, and the conversion ran here: the
    port's temporary cache holds the degree-4 setup's conversion."""
    assert settings.fs
    ret, (g1, g2) = JA.blst_tables(jax_ctx)
    assert ret == C_KZG_OK and len(g1) == 144 * N and len(g2) == 288 * 65
    assert ctypes.string_at(settings.g1_values, len(g1)) == g1
    assert ctypes.string_at(settings.g2_values, len(g2)) == g2
    assert os.listdir(srs.CACHE_DIR) == ["srs_0f1c825ca54c4fef.npz"]


def _setup_parts():
    g1, g2 = srs._parse_setup_text(open(SETUP_4).read())
    return b"".join(g1), len(g1), b"".join(g2), len(g2)


LOAD_CASES = {
    "bytes: one point each": lambda: (b"\x00" * 48, 1, b"\x00" * 96, 1),
    "bytes: the degree-4 points (not 4096 and 65)": _setup_parts,
    "bytes: 4096 and 65 zero points": lambda: (b"\x00" * 48 * 4096, 4096, b"\x00" * 96 * 65, 65),
    "file: empty": lambda: b"",
    "file: headers only": lambda: b"4\n65\n",
    "file: bad hex": lambda: b"1\n1\n" + b"zz" * 48 + b"\n" + b"00" * 96 + b"\n",
}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_bad_setup_matches_jax(lib, tmp_path, case):
    arg = LOAD_CASES[case]()
    s = KZGSettings()
    if case.startswith("bytes"):
        want, _ = JA.new_context_from_parts(*arg)
        got = lib.load_trusted_setup(ctypes.byref(s), arg[0], ctypes.c_size_t(arg[1]), arg[2],
                                     ctypes.c_size_t(arg[3]))
    else:
        want, _ = JA.new_context_from_text(arg)
        path = tmp_path / "setup.txt"
        path.write_bytes(arg)
        got, s = _load_file(lib, str(path))
    assert got == want == C_KZG_BADARGS
    assert not (s.fs or s.g1_values or s.g2_values)


def test_null_pointers_and_free(lib, settings):
    out = ctypes.create_string_buffer(48)
    ok = ctypes.c_bool(True)
    s = ctypes.byref(settings)
    assert lib.blob_to_kzg_commitment(out, None, s) == C_KZG_BADARGS  # as the JAX shim
    assert lib.verify_kzg_proof(ctypes.byref(ok), None, None, None, None, s) == C_KZG_BADARGS
    assert lib.verify_blob_kzg_proof(ctypes.byref(ok), None, None, None, s) == C_KZG_BADARGS
    assert lib.blob_to_kzg_commitment(out, bytes(BLOB_SIZE), ctypes.byref(KZGSettings())) == C_KZG_BADARGS
    assert lib.load_trusted_setup_file(None, None) == C_KZG_BADARGS
    empty = KZGSettings()
    lib.free_trusted_setup(ctypes.byref(empty))  # nothing loaded: a no-op
    lib.free_trusted_setup(None)
    assert not (empty.fs or empty.g1_values or empty.g2_values)
