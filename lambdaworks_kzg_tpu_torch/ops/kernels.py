"""The Hopper kernels (`csrc/g1.cu`, `csrc/msm.cu`, `csrc/table.cu`,
`csrc/g1_batch.cu`, `csrc/pairing.cu`, `csrc/fr_poly.cu`), their build and
their wrappers.

The paths run the TPU kernels `madd`, `add` and `dbl` of
`lambdaworks_kzg_tpu/ops/pallas_g1_v2.py` (and the v1-layout kernels of
`ops/pallas_g1.py`, which compute the same function) inside the MSM,
table, batched G1 and fold kernels below. `g1_madd` and `g1_dbl` (g1.cu)
and `g1_add` (g1_batch.cu) compute the three alone, on no path, checked
against `madd`, `dbl` and `add` of `ops/g1_ops.py`. `g1_fold`
(g1_batch.cu) folds a mesh's partials, K rows of points, with every level
of the plain `g1_ops.fold` in one launch; `g1_add` is its body on two
rows.
`g1_bucket_accumulate` and `g1_bucket_reduce` (msm.cu) run the MSMs' madd
rounds (chunks of at most L members of a bucket, one a lane) and their
reduce (each bucket's chunk partials merged pairwise, then the fold),
each in one launch per batch of blobs: the fixed-base MSM's blobs over
its table's rows, the generic MSM's windows over its points;
`g1_window_combine` (msm.cu) runs the generic MSM's Horner step over each
MSM's window sums, one launch per batch of MSMs. Their plain versions are
`g1_ops.accumulate_chunks`, `g1_ops.reduce_chunks` and
`g1_ops.combine_windows`.
`g1_fixedbase_table` (table.cu) builds the fixed-base table, doublings and
affine step, in one launch straight into the accumulation's row layout;
its plain version is `g1_ops.fixedbase_table`. `g1_decompress`,
`g1_scalar_mul`, `g1_fft_stage` and `g1_subgroup_mask` (g1_batch.cu) run
the batched G1 steps of setup conversion and batch verification
(`ops/g1_batch.py`), each whole loop, or FFT stage, in one launch; their
plain versions are `g1_ops.decompress_xy`, `g1_ops.scalar_mul`
(`g1_ops.scalar_mul_endo` in the split mode), `g1_ops.fft_stage_endo`
and `g1_ops.subgroup_mask`. All four run on the cooperative field of
`fp_coop.cuh` (four threads per element; four, eight or sixteen to a
lane).
`pairing_miller_loop` and `pairing_final_exp` (pairing.cu, on the
machine of levels of `levels.cuh`) run the pairing check of the device
pairing tier: the Miller loop of every pair in one launch (a block per
pair), then the pairs' product, the final exponentiation (cubed) and its
`== 1` in another (one block); each takes its level program
(`pairing_levels.programs`, built once and copied to the device once);
their plain versions are `pairing_ops.miller_loop_jac` and
`pairing_ops.final_exp_check`.
`fr_evaluate`, `fr_quotient` and `fr_quotient_in_domain` (fr_poly.cu, on
the Fr field of `fr.cuh`) run the three programs the JAX package jits once
per domain size (`lambdaworks_kzg_tpu/ops/fr_poly.py` `_eval_kernel`,
`_quotient_kernel`, `_quotient_in_domain_kernel`), each in one launch per
batch of blobs, on up to 8 blocks a blob (a thread block cluster for the
evaluation and the in-domain quotient), with no inversion on the card;
`fr_to_mont` puts evaluations into Montgomery form, on no path. Their
plain versions are
`FrDomain.evaluate_mont_plain`, `quotient_mont_plain`,
`quotient_in_domain_mont_plain` (`ops/fr_poly.py`) and `FR.to_mont`.
`fp_sqr_check` (g1.cu) returns the field's square and product a * a, to
hold one against the other, `fp_coop_check` (g1_batch.cu) the
cooperative field's product, square, sum, difference, zero test and
equality beside fp.cuh's product and square, and `fr_check` (fr_poly.cu)
fr.cuh's product, square, sum, difference, negation, inverse and
conversions.
The notes at the top of the sources say what bounds each kernel on the
card.

Build: at first use `nvcc` compiles each source for sm_90a, all at once,
and links the objects into one shared library with a plain C
interface in `_build/` beside this package (listed in .gitignore);
`ctypes` loads it. The library's name carries a hash of the sources and
flags, so an edit rebuilds. Processes that start together (test
workers, the ranks of a process group) build it once: one holds the
build's lock while the others wait, and the library is written under a
name of the building process's own and moved into place whole
(`utils/build.py`).

Wrappers take the kernel layout, int32 tensors that hold u32 limbs
(`limbs.to_u32_layout`): [3, 12, M] Jacobian, [2, 12, M] affine, a bool[M]
mask, and for the MSM the table (or the generic MSM's points) as rows
[M, 2, 12] with int32 `order` and `bstart`, its chunk partials as rows
[B K, 3, 12], all contiguous on one CUDA device, and the combine the
window sums [3, 12, B W]; the table build takes
the basis as [2, 12, N] affine with valid bool[N] and returns the rows;
the batched G1 kernels take x as [12, M], scalars as [8, M] u32 words
(or [8, 1], one scalar for every lane) and return bool[M] masks; the FFT
stage takes its n points [3, 12, n] in natural order and its twiddles
[8, n/2]; the fold takes the public int64 limbs [K, 3, 24, B] and
returns [3, 24, B]; the pairing kernels take G1 Jacobian [3, 12, B], G2
Jacobian [3, 2, 12, B] and Miller values [12, 12, B]
(`tower_ops.flatten12`); the
Fr kernels take the domain's roots [8, n] and 1/n [8, 1], the plain
evaluations as public int64 limbs [B, 16, n] and a table of each z,
[B, 8, log2 n + 1] (`fr_evaluate`, `fr_quotient`) or [B, 8, log2 n + 3]
with the in-domain index also as B host ints (`fr_quotient_in_domain`),
and return the plain y [B, 16, 1] or quotients [B, 16, n]; `fr_to_mont`
takes and returns [B, 8, n].
They allocate the output with `torch.empty`, launch on the current
stream, raise when the launch fails, and count their launches.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..constants import num_windows
from ..utils import build as B
from . import limbs as lb, pairing_levels, tower_ops
from .g1_ops import chunk_slots

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("g1.cu", "msm.cu", "table.cu", "g1_batch.cu", "pairing.cu", "fr_poly.cu")
HEADERS = ("fp.cuh", "fp_coop.cuh", "g1.cuh", "g1_coop.cuh", "levels.cuh", "fr.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NL = 12  # 32-bit limbs per Fp element in the kernel layout
FR_NL = 8  # 32-bit limbs per Fr element
MAX_C = 12  # window bits the MSM and table kernels take (auto_window picks 4, 8, 12)
MAX_CHUNK = 1024  # members a chunk of g1_bucket_accumulate takes at most
MAX_FOLD_ROWS = 256  # rows g1_fold takes: K / 2 points a column in shared memory

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda/bin or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path() -> str:
    return B.digest_path(BUILD_DIR, "liblwkzg", [os.path.join(CSRC, f) for f in SOURCES + HEADERS],
                         NVCC_FLAGS)


def build() -> dict:
    """Compile the kernels if these sources have no library yet.

    Returns {"library", "seconds", "built", "log"}; `log` holds nvcc's
    output, including ptxas' register and spill report."""
    lib_path = _library_path()
    with B.exclusive(lib_path):
        return _build(lib_path)


def _build(lib_path: str) -> dict:
    log_path = lib_path[:-3] + ".log"
    if os.path.exists(lib_path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"library": lib_path, "seconds": 0.0, "built": False, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objects = [f"{tmp}.{src}.o" for src in SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        procs = list(pool.map(
            lambda src, obj: subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
                                            capture_output=True, text=True),
            SOURCES, objects))
    if all(proc.returncode == 0 for proc in procs):
        procs.append(subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objects],
                                    capture_output=True, text=True))
    seconds = time.perf_counter() - t0
    log = "".join(proc.stdout + proc.stderr for proc in procs)
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    failed = [proc for proc in procs if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n{log}")
    with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
        f.write(log)
    os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
    os.replace(tmp, lib_path)
    return {"library": lib_path, "seconds": seconds, "built": True, "log": log}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["library"])
            vp, ci, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
            lib.lwkzg_g1_madd.argtypes = [vp, vp, vp, vp, ci, vp]
            lib.lwkzg_g1_add.argtypes = [vp, vp, vp, ci, vp]
            lib.lwkzg_g1_dbl.argtypes = [vp, vp, ci, vp]
            lib.lwkzg_g1_bucket_accumulate.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
            lib.lwkzg_g1_bucket_reduce.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
            lib.lwkzg_g1_window_combine.argtypes = [vp, vp, ci, ci, ci, vp]
            lib.lwkzg_g1_fixedbase_table.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            lib.lwkzg_fp_sqr_check.argtypes = [vp, vp, vp, ci, vp]
            lib.lwkzg_g1_decompress.argtypes = [vp, vp, vp, vp, ci, vp]
            lib.lwkzg_g1_scalar_mul.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp]
            lib.lwkzg_fp_coop_check.argtypes = [vp, vp, vp, ci, vp]
            lib.lwkzg_g1_subgroup_mask.argtypes = [vp, vp, ci, vp]
            lib.lwkzg_g1_fft_stage.argtypes = [vp, vp, vp, ci, ci, vp]
            lib.lwkzg_g1_fold.argtypes = [vp, vp, ci, ci, vp]
            lib.lwkzg_pairing_miller_loop.argtypes = [vp, vp, vp, ci, u64, vp, ci, ci, vp]
            lib.lwkzg_pairing_final_exp.argtypes = [vp, vp, vp, vp, ci, u64, u64, vp, ci, ci, vp]
            lib.lwkzg_pairing_smem.argtypes = [ci, ci, vp]
            lib.lwkzg_fr_evaluate.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp]
            lib.lwkzg_fr_quotient.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp]
            lib.lwkzg_fr_quotient_in_domain.argtypes = [vp, vp, vp, vp, ci, ci, vp]
            lib.lwkzg_fr_to_mont.argtypes = [vp, vp, ci, ci, vp]
            lib.lwkzg_fr_check.argtypes = [vp, vp, vp, ci, vp]
            fns = {
                "madd": lib.lwkzg_g1_madd, "add": lib.lwkzg_g1_add, "dbl": lib.lwkzg_g1_dbl,
                "bucket_accumulate": lib.lwkzg_g1_bucket_accumulate,
                "bucket_reduce": lib.lwkzg_g1_bucket_reduce,
                "window_combine": lib.lwkzg_g1_window_combine,
                "fixedbase_table": lib.lwkzg_g1_fixedbase_table,
                "sqr_check": lib.lwkzg_fp_sqr_check,
                "decompress": lib.lwkzg_g1_decompress,
                "scalar_mul": lib.lwkzg_g1_scalar_mul,
                "subgroup_mask": lib.lwkzg_g1_subgroup_mask,
                "fft_stage": lib.lwkzg_g1_fft_stage,
                "fold": lib.lwkzg_g1_fold,
                "coop_check": lib.lwkzg_fp_coop_check,
                "miller_loop": lib.lwkzg_pairing_miller_loop,
                "final_exp": lib.lwkzg_pairing_final_exp,
                "pairing_smem": lib.lwkzg_pairing_smem,
                "fr_evaluate": lib.lwkzg_fr_evaluate,
                "fr_quotient": lib.lwkzg_fr_quotient,
                "fr_quotient_in_domain": lib.lwkzg_fr_quotient_in_domain,
                "fr_to_mont": lib.lwkzg_fr_to_mont,
                "fr_check": lib.lwkzg_fr_check,
            }
            for fn in fns.values():
                fn.restype = ci
            _lib = fns
    return _lib


def _check(t: torch.Tensor, name: str, shape, device, dtype=torch.int32) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_c(c: int) -> None:
    if not 1 <= c <= MAX_C:
        raise ValueError(f"window bits c must be in [1, {MAX_C}], got {c}")


def _run(name: str, t: torch.Tensor, *args) -> None:
    """Launch on t's device and its current stream (the last argument)."""
    fn = _load()[name]
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


class _Kernel:
    """A kernel wrapper with a plain-integer launch count."""

    def __init__(self, name: str, replaces: str, launch):
        self.name = name
        self.replaces = replaces
        self._launch = launch
        self.launches = 0

    def __call__(self, *args, **kwargs):
        return self._launch(self, *args, **kwargs)


def _madd(k: _Kernel, p: torch.Tensor, q: torch.Tensor, live: torch.Tensor):
    m = p.shape[-1]
    _check(p, "p", (3, NL, m), p.device)
    _check(q, "q", (2, NL, m), p.device)
    _check(live, "live", (m,), p.device, torch.bool)
    out = torch.empty_like(p)
    if m:
        _run("madd", p, p.data_ptr(), q.data_ptr(), live.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


def _add(k: _Kernel, p: torch.Tensor, q: torch.Tensor):
    m = p.shape[-1]
    _check(p, "p", (3, NL, m), p.device)
    _check(q, "q", (3, NL, m), p.device)
    out = torch.empty_like(p)
    if m:
        _run("add", p, p.data_ptr(), q.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


def _dbl(k: _Kernel, p: torch.Tensor):
    m = p.shape[-1]
    _check(p, "p", (3, NL, m), p.device)
    out = torch.empty_like(p)
    if m:
        _run("dbl", p, p.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


def _check_chunk(c: int, chunk: int) -> None:
    _check_c(c)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def _bucket_accumulate(k: _Kernel, table: torch.Tensor, order: torch.Tensor,
                       bstart: torch.Tensor, c: int, chunk: int):
    """table [W N, 2, 12] affine rows; order [B, W N] member indices in
    digit-sorted order, each in [0, W N); bstart [B, 2^c] non-decreasing
    run starts in [0, W N] (as `torch.sort` and `torch.searchsorted` give
    them) -> chunk partials, rows [B K, 3, 12], K = g1_ops.chunk_slots(W
    N, c, chunk): chunks of at most `chunk` members, one a thread."""
    _check_chunk(c, chunk)
    dev = table.device
    n_members = table.shape[0]
    _check(table, "table", (n_members, 2, NL), dev)
    if table.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    b = order.shape[0]
    _check(order, "order", (b, n_members), dev)
    _check(bstart, "bstart", (b, 1 << c), dev)
    slots = chunk_slots(n_members, c, chunk)
    out = torch.empty((b * slots, 3, NL), dtype=torch.int32, device=dev)
    if b:
        _run("bucket_accumulate", table, table.data_ptr(), order.data_ptr(), bstart.data_ptr(),
             out.data_ptr(), n_members, c, chunk, slots, b)
        k.launches += 1
    return out


def _bucket_reduce(k: _Kernel, partials: torch.Tensor, bstart: torch.Tensor, c: int,
                   chunk: int, n_members: int):
    """Chunk partials [B K, 3, 12] of `bucket_accumulate` on blobs of
    n_members, with their bstart [B, 2^c] -> [3, 12, B]: per blob, each
    bucket's partials merged pairwise, then the fold reduce. The merge
    overwrites the partials."""
    _check_chunk(c, chunk)
    dev = partials.device
    b = bstart.shape[0]
    slots = chunk_slots(n_members, c, chunk)
    _check(partials, "partials", (b * slots, 3, NL), dev)
    _check(bstart, "bstart", (b, 1 << c), dev)
    out = torch.empty((3, NL, b), dtype=torch.int32, device=dev)
    if b:
        work = torch.zeros(b, dtype=torch.int32, device=dev)  # a barrier count a blob
        scratch = torch.empty((b, 3 << (c - 1), 3 * NL), dtype=torch.int32, device=dev)
        _run("bucket_reduce", partials, partials.data_ptr(), bstart.data_ptr(), work.data_ptr(),
             scratch.data_ptr(), out.data_ptr(), n_members, c, chunk, slots, b)
        k.launches += 1
    return out


def _window_combine(k: _Kernel, sums: torch.Tensor, c: int, windows: int):
    """Window sums [3, 12, B W] Jacobian, MSM b's window w at lane b W + w
    -> [3, 12, B]: sum_w 2^(c w) S_w per MSM by Horner (c doublings and
    an add a window, from S_{W-1} down), as `g1_ops.combine_windows`."""
    _check_c(c)
    lanes = sums.shape[-1]
    if windows < 1 or lanes % windows:
        raise ValueError(f"{lanes} window sums do not split into MSMs of {windows} windows")
    _check(sums, "sums", (3, NL, lanes), sums.device)
    b = lanes // windows
    out = torch.empty((3, NL, b), dtype=torch.int32, device=sums.device)
    if b:
        _run("window_combine", sums, sums.data_ptr(), out.data_ptr(), b, windows, c)
        k.launches += 1
    return out


def _fixedbase_table(k: _Kernel, points: torch.Tensor, valid: torch.Tensor, c: int):
    """points [2, 12, N] affine basis + valid bool[N] -> table rows
    [W N, 2, 12], W = ceil(256 / c): row w N + i is the affine
    [2^(c w)] P_i, and (0, 0) in every window where P_i is invalid."""
    _check_c(c)
    dev = points.device
    n = points.shape[-1]
    _check(points, "points", (2, NL, n), dev)
    _check(valid, "valid", (n,), dev, torch.bool)
    w = num_windows(c)
    out = torch.empty((w * n, 2, NL), dtype=torch.int32, device=dev)
    if n:
        # per (window, lane): Z and the prefix product of the Z's before it
        scratch = torch.empty((w, 2, NL, n), dtype=torch.int32, device=dev)
        _run("fixedbase_table", points, points.data_ptr(), valid.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), n, c, w)
        k.launches += 1
    return out


def _sqr_check(k: _Kernel, a: torch.Tensor):
    """a [12, M] values below p -> (fp::sqr(a), fp::mul(a, a)), each [12, M]."""
    m = a.shape[-1]
    _check(a, "a", (NL, m), a.device)
    sq, mm = torch.empty_like(a), torch.empty_like(a)
    if m:
        _run("sqr_check", a, a.data_ptr(), sq.data_ptr(), mm.data_ptr(), m)
        k.launches += 1
    return sq, mm


def _decompress(k: _Kernel, x: torch.Tensor, want_largest: torch.Tensor):
    """x [12, M] Montgomery + want_largest bool[M] -> (y [12, M], qr
    bool[M]): y^2 = x^3 + 4 where qr, with "y > (p-1)/2" as asked."""
    m = x.shape[-1]
    _check(x, "x", (NL, m), x.device)
    _check(want_largest, "want_largest", (m,), x.device, torch.bool)
    y = torch.empty_like(x)
    qr = torch.empty(m, dtype=torch.bool, device=x.device)
    if m:
        _run("decompress", x, x.data_ptr(), want_largest.data_ptr(), y.data_ptr(), qr.data_ptr(), m)
        k.launches += 1
    return y, qr


def _scalar_mul(k: _Kernel, p: torch.Tensor, scalars: torch.Tensor, nbits: int,
                split: bool = False):
    """p [3, 12, M] Jacobian, scalars [8, M] (or [8, 1] for every lane)
    plain u32 words -> [k_m] P_m [3, 12, M]; bits at or above nbits are
    not read. split: words 0-3 hold k1 and words 4-7 k2 (nbits must be
    128, each half's width), and the result is [k1]P + [k2](BETA X, -Y, Z),
    which is [k1 + k2 x^2]P only for P in G1."""
    if not 0 <= nbits <= 256:
        raise ValueError(f"nbits must be in [0, 256], got {nbits}")
    if split and nbits != 128:
        raise ValueError(f"the split mode reads two 128-bit halves, got nbits {nbits}")
    m = p.shape[-1]
    _check(p, "p", (3, NL, m), p.device)
    lanes = 1 if scalars.dim() == 2 and scalars.shape[-1] == 1 else m
    _check(scalars, "scalars", (8, lanes), p.device)
    out = torch.empty_like(p)
    if m:
        _run("scalar_mul", p, p.data_ptr(), scalars.data_ptr(), int(lanes != 1), out.data_ptr(), m,
             nbits, int(split))
        k.launches += 1
    return out


def _fft_stage(k: _Kernel, a: torch.Tensor, length: int, twiddles: torch.Tensor):
    """One stage of the conversion's FFT: a [3, 12, n] Jacobian points of
    G1 in natural order (n a power of two), the stage length l (a power of
    two in [2, n]) and its split twiddles [8, n/2] (k1 in words 0-3, k2 in
    4-7, butterfly j's in column j) -> [3, 12, n]. Butterfly j, with
    h = l/2, takes even = a[e], e = (j / h) l + j % h, and odd = a[e + h],
    and writes even + t at e and even - t at e + h, t = [k1 + k2 x^2] odd
    (which is [w_j] odd only for odd in G1)."""
    n = a.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"the FFT length must be a power of two >= 2, got {n}")
    if length < 2 or length & (length - 1) or length > n:
        raise ValueError(f"the stage length must be a power of two in [2, {n}], got {length}")
    _check(a, "a", (3, NL, n), a.device)
    _check(twiddles, "twiddles", (8, n // 2), a.device)
    out = torch.empty_like(a)
    _run("fft_stage", a, a.data_ptr(), twiddles.data_ptr(), out.data_ptr(), n, length)
    k.launches += 1
    return out


def _subgroup_mask(k: _Kernel, p: torch.Tensor):
    """p [3, 12, M] Jacobian -> bool[M], P in G1; infinity passes."""
    m = p.shape[-1]
    _check(p, "p", (3, NL, m), p.device)
    out = torch.empty(m, dtype=torch.bool, device=p.device)
    if m:
        _run("subgroup_mask", p, p.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


def _fold(k: _Kernel, points: torch.Tensor):
    """points [K, 3, 24, B] Jacobian, public int64 limbs, 2 <= K <=
    MAX_FOLD_ROWS -> [3, 24, B]: the rows folded as `g1_ops.fold` does,
    each level adding row j to row half + j, an odd last row waiting."""
    if points.dim() != 4 or not 2 <= points.shape[0] <= MAX_FOLD_ROWS:
        raise ValueError(f"points must be [K, 3, {2 * NL}, B] with 2 <= K <= {MAX_FOLD_ROWS}, "
                         f"got {tuple(points.shape)}")
    rows, b = points.shape[0], points.shape[-1]
    _check(points, "points", (rows, 3, 2 * NL, b), points.device, torch.int64)
    out = torch.empty((3, 2 * NL, b), dtype=torch.int64, device=points.device)
    if b:
        _run("fold", points, points.data_ptr(), out.data_ptr(), rows, b)
        k.launches += 1
    return out


def _coop_check(k: _Kernel, a: torch.Tensor, b: torch.Tensor):
    """a, b [12, M] values below p -> [7, 12, M]: the cooperative field's
    mul(a, b), sqr(a), add(a, b), sub(a, b), then fp::mul(a, b), fp::sqr(a),
    and [6, 0] / [6, 1] its is_zero(a) / eq(a, b) as 0 or 1."""
    m = a.shape[-1]
    _check(a, "a", (NL, m), a.device)
    _check(b, "b", (NL, m), a.device)
    out = torch.empty((7, NL, m), dtype=torch.int32, device=a.device)
    if m:
        _run("coop_check", a, a.data_ptr(), b.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


_GAMMA = {}


def _gamma(device) -> torch.Tensor:
    """gamma_k = xi^(k (p - 1) / 6), k < 6, as [6, 2, 12] Montgomery u32
    words: the plain tower's constants (`tower_ops._gamma`, slot (i, j)
    holds k = 2 j + i) in the kernel's layout."""
    key = str(device)
    if key not in _GAMMA:
        g = tower_ops._gamma(device).transpose(0, 1).reshape(6, 2, tower_ops.L, 1)
        _GAMMA[key] = lb.to_u32_layout(g).reshape(6, 2, NL)
    return _GAMMA[key]


_PROGRAM = {}


def _program(which: int, device):
    """(the level program as int32 on device, the shared-memory bytes of
    its slots and its copy); which: 0 the Miller loop, 1 the final
    exponentiation. The first call on a device copies the program there
    and lets the kernel take that much shared memory."""
    key = (which, str(device))
    if key not in _PROGRAM:
        prog = pairing_levels.programs()[which]
        words = torch.tensor(prog.words, dtype=torch.int32, device=device)
        smem = (prog.slots * pairing_levels.WORDS + len(prog.words)) * 4
        _run("pairing_smem", words, which, smem)
        _PROGRAM[key] = (words, smem)
    return _PROGRAM[key]


def _miller_loop(k: _Kernel, p: torch.Tensor, q: torch.Tensor):
    """p [3, 12, B] G1 and q [3, 2, 12, B] G2 Jacobian -> the Miller
    values [12, 12, B], conjugated, one where a member is at infinity."""
    b = p.shape[-1]
    _check(p, "p", (3, NL, b), p.device)
    _check(q, "q", (3, 2, NL, b), p.device)
    out = torch.empty((12, NL, b), dtype=torch.int32, device=p.device)
    if b:
        prog, smem = _program(0, p.device)
        _run("miller_loop", p, p.data_ptr(), q.data_ptr(), out.data_ptr(), b,
             pairing_levels.X_ABS, prog.data_ptr(), prog.numel(), smem)
        k.launches += 1
    return out


def _final_exp(k: _Kernel, f: torch.Tensor):
    """f [12, 12, B] Miller values, B >= 1 -> (FE(prod f)^3 [12, 12, 1],
    its == 1 as bool[1])."""
    b = f.shape[-1]
    if b < 1:
        raise ValueError("the final exponentiation needs at least one lane")
    _check(f, "f", (12, NL, b), f.device)
    gamma = _gamma(f.device)
    prog, smem = _program(1, f.device)
    out = torch.empty((12, NL, 1), dtype=torch.int32, device=f.device)
    ok = torch.empty(1, dtype=torch.bool, device=f.device)
    _run("final_exp", f, f.data_ptr(), gamma.data_ptr(), out.data_ptr(), ok.data_ptr(), b,
         pairing_levels.X_ABS, pairing_levels.XM1_ABS, prog.data_ptr(), prog.numel(), smem)
    k.launches += 1
    return out, ok


def _check_domain(evals: torch.Tensor, roots: torch.Tensor, min_n: int = 2) -> tuple:
    """-> (B, n) of plain evaluations as public int64 limbs [B, 16, n] over
    roots [8, n] on one device, n a power of two, at least min_n."""
    if evals.dim() != 3:
        raise ValueError(f"evals must be [B, 16, n], got {tuple(evals.shape)}")
    b, n = evals.shape[0], evals.shape[-1]
    if n < min_n or n & (n - 1):
        raise ValueError(f"the domain size must be a power of two, at least {min_n}, got {n}")
    _check(evals, "evals", (b, 16, n), evals.device, torch.int64)
    _check(roots, "roots", (FR_NL, n), evals.device)
    return b, n


def _fr_evaluate(k: _Kernel, evals: torch.Tensor, table: torch.Tensor, roots: torch.Tensor,
                 n_inv: torch.Tensor):
    """evals [B, 16, n] plain public int64 limbs, each z's table
    [B, 8, log2 n + 1] (`FrDomain.z_table`: z^(2^l) in column l), roots
    [8, n], 1/n [8, 1] -> plain y [B, 16, 1]: (z^n - 1) / n *
    sum_i e_i w_i / (z - w_i), the stored element e_m at z = w_m."""
    b, n = _check_domain(evals, roots)
    dev = evals.device
    _check(table, "table", (b, FR_NL, n.bit_length()), dev)
    _check(n_inv, "n_inv", (FR_NL, 1), dev)
    out = torch.empty((b, 16, 1), dtype=torch.int64, device=dev)
    if b:
        _run("fr_evaluate", evals, evals.data_ptr(), table.data_ptr(), roots.data_ptr(),
             n_inv.data_ptr(), out.data_ptr(), b, n)
        k.launches += 1
    return out


def _fr_quotient(k: _Kernel, evals: torch.Tensor, y: torch.Tensor, table: torch.Tensor,
                 roots: torch.Tensor):
    """evals [B, 16, n] and y [B, 16, 1] plain public int64 limbs, each
    z's table [B, 8, log2 n + 1] (`FrDomain.z_table`: z^(2^l) in column l,
    K = 1 / (z^n - 1) in the last), roots [8, n], z outside the domain ->
    PLAIN q [B, 16, n], q_i = (e_i - y) / (w_i - z)."""
    b, n = _check_domain(evals, roots)
    _check(y, "y", (b, 16, 1), evals.device, torch.int64)
    _check(table, "table", (b, FR_NL, n.bit_length()), evals.device)
    out = torch.empty_like(evals)
    if b:
        _run("fr_quotient", evals, evals.data_ptr(), y.data_ptr(), table.data_ptr(), roots.data_ptr(),
             out.data_ptr(), b, n)
        k.launches += 1
    return out


def _fr_quotient_in_domain(k: _Kernel, evals: torch.Tensor, m, table: torch.Tensor,
                           roots: torch.Tensor):
    """evals [B, 16, n] plain public int64 limbs, the index m of each
    blob's z = w_m as B host ints, and their table [B, 8, log2 n + 3]
    (`FrDomain.root_table`: z^(2^l) in column l, then K = w_m / n, 1/z and
    m, which the kernel reads), roots [8, n] -> PLAIN q [B, 16, n] with
    y = e_m: q_i = (e_i - y) / (w_i - z) for i != m and
    q_m = sum_{i != m} (e_i - y) w_i / (z (z - w_i)). Raises, before any
    launch, unless each m is in [0, n)."""
    b, n = _check_domain(evals, roots, min_n=1)
    m = [int(i) for i in m]
    if len(m) != b or any(not 0 <= i < n for i in m):
        raise ValueError(f"m must be {b} indices in [0, {n}), got {m}")
    _check(table, "table", (b, FR_NL, n.bit_length() + 2), evals.device)
    out = torch.empty_like(evals)
    if b:
        _run("fr_quotient_in_domain", evals, evals.data_ptr(), table.data_ptr(), roots.data_ptr(),
             out.data_ptr(), b, n)
        k.launches += 1
    return out


def _fr_to_mont(k: _Kernel, a: torch.Tensor):
    """a [B, 8, n] plain values below r -> their Montgomery form, a R mod r."""
    if a.dim() != 3:
        raise ValueError(f"a must be [B, {FR_NL}, n], got {tuple(a.shape)}")
    b, n = a.shape[0], a.shape[-1]
    _check(a, "a", (b, FR_NL, n), a.device)
    out = torch.empty_like(a)
    if b * n:
        _run("fr_to_mont", a, a.data_ptr(), out.data_ptr(), b, n)
        k.launches += 1
    return out


def _fr_check(k: _Kernel, a: torch.Tensor, b: torch.Tensor):
    """a, b [8, M] values below r -> [8, 8, M]: fr.cuh's mul(a, b), sqr(a),
    add(a, b), sub(a, b), neg(a), inv(a), to_mont(a), from_mont(a)."""
    m = a.shape[-1]
    _check(a, "a", (FR_NL, m), a.device)
    _check(b, "b", (FR_NL, m), a.device)
    out = torch.empty((8, FR_NL, m), dtype=torch.int32, device=a.device)
    if m:
        _run("fr_check", a, a.data_ptr(), b.data_ptr(), out.data_ptr(), m)
        k.launches += 1
    return out


_V2 = "lambdaworks_kzg_tpu/ops/pallas_g1_v2.py"
madd = _Kernel("g1_madd", f"{_V2}:353", _madd)
add = _Kernel("g1_add", f"{_V2}:376", _add)
# the add launches of the mesh's fold, one per level
# (lambdaworks_kzg_tpu/parallel/msm.py:40 _tree_fold_points), in one launch
fold = _Kernel("g1_fold", f"{_V2}:376", _fold)
dbl = _Kernel("g1_dbl", f"{_V2}:392", _dbl)
# the madd of the lock-step rounds (lambdaworks_kzg_tpu/ops/msm.py:787-852)
bucket_accumulate = _Kernel("g1_bucket_accumulate", f"{_V2}:353", _bucket_accumulate)
# the add of the fold reduce and group tree (ops/msm.py:598-621, :447-477)
bucket_reduce = _Kernel("g1_bucket_reduce", f"{_V2}:376", _bucket_reduce)
# the Horner step over windows of the generic MSM: combine_windows_host
# (ops/msm.py:671), and the same step of _bucket_reduce_fold (:618-620)
window_combine = _Kernel("g1_window_combine", "lambdaworks_kzg_tpu/ops/msm.py:671",
                         _window_combine)
# the doubling scan and affine step of the table build (ops/msm.py:714-750)
fixedbase_table = _Kernel("g1_fixedbase_table", f"{_V2}:392", _fixedbase_table)
# the square root and sign choice of decompression (XLA field ops in
# lambdaworks_kzg_tpu/ops/g1_batch.py:156-179), and the fori_loops of add
# and dbl launches in its scalar_mul_fixed / scalar_mul_per_lane (:45-85)
# and subgroup_mask (:126-145)
decompress = _Kernel("g1_decompress", "lambdaworks_kzg_tpu/ops/g1_batch.py:156", _decompress)
scalar_mul = _Kernel("g1_scalar_mul", f"{_V2}:376", _scalar_mul)
subgroup_mask = _Kernel("g1_subgroup_mask", f"{_V2}:392", _subgroup_mask)
# one stage of the G1 FFT: the per-lane scalar multiplication and the two
# add launches of the butterflies (lambdaworks_kzg_tpu/ops/g1_batch.py:270-272)
fft_stage = _Kernel("g1_fft_stage", "lambdaworks_kzg_tpu/ops/g1_batch.py:270", _fft_stage)
# the pairing tier's XLA steps (lambdaworks_kzg_tpu/ops/pairing_ops.py): the
# affine conversions and the Miller loop; the lane product, the final
# exponentiation and its == 1
_PAIRING = "lambdaworks_kzg_tpu/ops/pairing_ops.py"
miller_loop = _Kernel("pairing_miller_loop", f"{_PAIRING}:176", _miller_loop)
final_exp = _Kernel("pairing_final_exp", f"{_PAIRING}:243", _final_exp)
# the Fr layer's jitted XLA programs (lambdaworks_kzg_tpu/ops/fr_poly.py),
# and the XLA FR.to_mont before them (its open path, ops/backend.py:397)
_FR = "lambdaworks_kzg_tpu/ops/fr_poly.py"
fr_evaluate = _Kernel("fr_evaluate", f"{_FR}:66", _fr_evaluate)
fr_quotient = _Kernel("fr_quotient", f"{_FR}:82", _fr_quotient)
fr_quotient_in_domain = _Kernel("fr_quotient_in_domain", f"{_FR}:94", _fr_quotient_in_domain)
fr_to_mont = _Kernel("fr_to_mont", "lambdaworks_kzg_tpu/ops/field_ops.py:97", _fr_to_mont)
ALL = (madd, add, dbl, fold, bucket_accumulate, bucket_reduce, window_combine, fixedbase_table,
       decompress, scalar_mul, subgroup_mask, fft_stage, miller_loop, final_exp, fr_to_mont,
       fr_evaluate, fr_quotient, fr_quotient_in_domain)
# a check of the field's square, off every path (the TPU kernels' _sqr_acc)
sqr_check = _Kernel("fp_sqr_check", "lambdaworks_kzg_tpu/ops/pallas_g1.py:142", _sqr_check)
# a check of the cooperative field, off every path (the TPU kernels' _KernelFp)
coop_check = _Kernel("fp_coop_check", f"{_V2}:166", _coop_check)
# a check of the Fr field, off every path (the XLA FR of the Fr programs)
fr_check = _Kernel("fr_check", "lambdaworks_kzg_tpu/ops/field_ops.py:164", _fr_check)


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
