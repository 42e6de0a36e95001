"""The native C++ tier: ctypes bindings to `csrc/native/bls12_381.cpp`
(the JAX package's `native.py`, the same functions and byte layouts).

Pairing checks, subgroup tests, single scalar multiplications, point
decompression, one blob's evaluation and small MSMs are latency-bound
work on a handful of points: ~100x too slow in Python ints, and too
small to fill a card. The library mirrors the host oracle's formulas one
to one (`host/`), and `tests/test_torch_native.py` holds every function
against it.

Build: at first use `$CXX` (default `g++`) compiles the port's own copy
of the source with the JAX Makefile's flags into `_build/`, under a name
that carries a digest of the sources and flags (`utils/build.py`: one
process builds while the others wait, and the file appears whole).
`lw_init()`'s self-check must return 0. A failed build or self-check
raises `RuntimeError`; there is no quiet fallback to Python ints.
LWKZG_NATIVE=0 turns the tier off: `available()` is then False and the
callers take their other tier.

LWKZG_NATIVE_LIB=<path>, read at the first load, loads that build of the
same ABI instead of building one (JAX's `native.py`): a missing file or
one that fails to load or to pass `lw_init` raises `RuntimeError`, with
no fallback to the default build. `build(flags=ASAN_CXXFLAGS)` makes the
sanitizer build (ASan + UBSan at -O1, the JAX `native/Makefile`'s `asan`
flags) under its own digest name beside the -O3 one;
`scripts/torch_native_asan.py` runs `tests/test_torch_native.py` on it.

Affine points are (x, y) ints, G2 ((x0, x1), (y0, y1)), None for
infinity; coordinates travel as 48-byte big-endian words.
"""

import ctypes
import os
import subprocess
import threading
import time

from .constants import R
from .utils import build as B

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "csrc", "native")
SOURCES = ("bls12_381.cpp", "hard_exp.inc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")
ASAN_CXXFLAGS = ("-O1", "-g", "-fPIC", "-Wall", "-Wextra", "-std=c++17",
                 "-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-shared")

_lock = threading.Lock()
_lib = None


def library_path(build_dir: str = BUILD_DIR, flags=CXXFLAGS) -> str:
    return B.digest_path(build_dir, "libbls12381_native",
                         [os.path.join(SOURCE_DIR, s) for s in SOURCES], flags)


def build(build_dir: str = BUILD_DIR, flags=CXXFLAGS) -> dict:
    """Compile the library with `flags` if these sources have none yet in
    build_dir. -> {"library", "seconds", "built", "log"}; RuntimeError
    when the compiler fails or is missing."""
    lib_path = library_path(build_dir, flags)
    with B.exclusive(lib_path):
        if os.path.exists(lib_path):
            return {"library": lib_path, "seconds": 0.0, "built": False, "log": ""}
        cxx = os.environ.get("CXX") or "g++"
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [cxx, *flags, os.path.join(SOURCE_DIR, SOURCES[0]), "-o", tmp]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            rc, log = proc.returncode, proc.stdout + proc.stderr
        except (OSError, subprocess.TimeoutExpired) as e:
            rc, log = None, repr(e)
        seconds = time.perf_counter() - t0
        if rc != 0 or not os.path.exists(tmp):
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"the native tier did not build: {' '.join(cmd)} -> {rc}; compiler output:\n{log}\n"
                "Set LWKZG_NATIVE=0 to run without the native tier.")
        os.replace(tmp, lib_path)
    return {"library": lib_path, "seconds": seconds, "built": True, "log": log}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            named = os.environ.get("LWKZG_NATIVE_LIB")
            if named and not os.path.isfile(named):
                raise RuntimeError(f"LWKZG_NATIVE_LIB names no file: {named}")
            try:
                lib = ctypes.CDLL(named or build()["library"])
            except OSError as e:
                raise RuntimeError(f"the native tier did not load: {e}") from e
            p, i, n = ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t
            signatures = {
                "lw_init": [],
                "lw_pairings_verify": [p, i, p, i, p, i, p, i],
                "lw_g1_in_subgroup": [p],
                "lw_g2_in_subgroup": [p],
                "lw_g1_scalar_mul": [p, p, p],
                "lw_g2_scalar_mul": [p, p, p],
                "lw_blob_eval": [p, p, n, p, p],
                "lw_g1_decompress": [p, p, i],
                "lw_g1_msm": [i, p, p, p, p],
            }
            for name, argtypes in signatures.items():
                if not hasattr(lib, name):
                    raise RuntimeError(f"the native library {lib._name} has no {name}")
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, i
            rc = lib.lw_init()
            if rc != 0:
                raise RuntimeError(f"the native tier's self-check (lw_init) returned {rc}. "
                                   "Set LWKZG_NATIVE=0 to run without the native tier.")
            _lib = lib
    return _lib


def available() -> bool:
    """False when LWKZG_NATIVE=0 (read at every call); else builds and
    loads the library if that has not happened yet (RuntimeError when it
    fails) and is True."""
    if os.environ.get("LWKZG_NATIVE") == "0":
        return False
    _load()
    return True


def _g1_bytes(aff) -> bytes:
    x, y = aff
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def _g2_bytes(aff) -> bytes:
    (x0, x1), (y0, y1) = aff
    return b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1))


def _words(raw: bytes, count: int) -> list:
    return [int.from_bytes(raw[48 * i : 48 * (i + 1)], "big") for i in range(count)]


def _g1_out(out) -> tuple:
    x, y = _words(out.raw, 2)
    return x, y


def pairings_verify_affine(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2) for affine points (None = infinity)."""
    lib = _load()

    def arg(aff, size, to_bytes):
        return (b"\x00" * size, 1) if aff is None else (to_bytes(aff), 0)

    return lib.lw_pairings_verify(*arg(a1, 96, _g1_bytes), *arg(a2, 192, _g2_bytes),
                                  *arg(b1, 96, _g1_bytes), *arg(b2, 192, _g2_bytes)) == 1


def g1_in_subgroup_affine(aff) -> bool:
    return _load().lw_g1_in_subgroup(_g1_bytes(aff)) == 1


def g2_in_subgroup_affine(aff) -> bool:
    return _load().lw_g2_in_subgroup(_g2_bytes(aff)) == 1


def g1_scalar_mul_affine(aff, k: int):
    """[k]P -> affine (x, y), or None for infinity."""
    out = ctypes.create_string_buffer(96)
    if _load().lw_g1_scalar_mul(_g1_bytes(aff), (k % (1 << 256)).to_bytes(32, "big"), out):
        return None
    return _g1_out(out)


def g2_scalar_mul_affine(aff, k: int):
    """[k]Q -> affine ((x0, x1), (y0, y1)), or None for infinity."""
    out = ctypes.create_string_buffer(192)
    if _load().lw_g2_scalar_mul(_g2_bytes(aff), (k % (1 << 256)).to_bytes(32, "big"), out):
        return None
    x0, x1, y0, y1 = _words(out.raw, 4)
    return (x0, x1), (y0, y1)


def blob_eval(blob: bytes, roots_brp_le: bytes, n: int, z: int) -> int:
    """p(z) for an evaluation-form blob by the barycentric formula.

    roots_brp_le: the domain in bit-reversed order as n 32-byte
    little-endian words. ValueError on a non-canonical element (>= r)
    and on a blob or domain of the wrong size."""
    if len(blob) != 32 * n or len(roots_brp_le) != 32 * n:
        raise ValueError(f"blob and domain must be {32 * n} bytes")
    out = ctypes.create_string_buffer(32)
    rc = _load().lw_blob_eval(bytes(blob), bytes(roots_brp_le), n, (z % R).to_bytes(32, "little"), out)
    if rc == 2:
        raise ValueError("non-canonical field element in blob (>= r)")
    if rc != 0:
        raise ValueError(f"blob_eval failed ({rc})")
    return int.from_bytes(out.raw[:32], "little")


_DECOMPRESS_ERRORS = {-1: "bad encoding", -2: "x >= p", -3: "not on curve", -4: "not in subgroup"}


def g1_decompress(data: bytes, subgroup_check: bool = True):
    """48-byte compressed G1 -> affine (x, y), or None for infinity, with
    the rejections of `host/curve.decompress_g1`: ValueError "bad
    encoding", "x >= p", "not on curve" or "not in subgroup"."""
    if len(data) != 48:
        raise ValueError("bad length")
    out = ctypes.create_string_buffer(96)
    rc = _load().lw_g1_decompress(bytes(data), out, 1 if subgroup_check else 0)
    if rc == 1:
        return None
    if rc in _DECOMPRESS_ERRORS:
        raise ValueError(_DECOMPRESS_ERRORS[rc])
    if rc != 0:
        raise ValueError(f"decompress failed ({rc})")
    return _g1_out(out)


def g1_msm_affine(scalars, points_affine):
    """sum_i k_i P_i by a small Pippenger -> affine (x, y), or None for
    infinity. Scalars are ints (reduce them mod r first), points affine
    or None."""
    n = len(points_affine)
    if len(scalars) != n:
        raise ValueError("length mismatch")
    sc = b"".join((int(s) % (1 << 256)).to_bytes(32, "big") for s in scalars)
    pts = bytearray(96 * n)
    infs = bytearray(n)
    for i, pt in enumerate(points_affine):
        if pt is None:
            infs[i] = 1
        else:
            pts[96 * i : 96 * i + 96] = _g1_bytes(pt)
    out = ctypes.create_string_buffer(96)
    rc = _load().lw_g1_msm(n, sc, bytes(pts), bytes(infs), out)
    if rc == 1:
        return None
    if rc != 0:
        raise ValueError(f"msm failed ({rc})")
    return _g1_out(out)
