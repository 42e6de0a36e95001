"""The Hopper kernels (`csrc/g1.cu`, `csrc/msm.cu`), their build and their
wrappers.

`g1_madd`, `g1_add` and `g1_dbl` (g1.cu) replace the TPU kernels `madd`,
`add` and `dbl` of `lambdaworks_kzg_tpu/ops/pallas_g1_v2.py` (and the
v1-layout kernels of `ops/pallas_g1.py`, which compute the same function);
their plain versions are `madd`, `add` and `dbl` of `ops/g1_ops.py`.
`g1_bucket_accumulate` and `g1_bucket_reduce` (msm.cu) run the fixed-base
MSM's lock-step madd rounds and its fold reduce with the group tree, each
in one launch per batch of blobs; their plain versions are
`g1_ops.bucket_accumulate` and `g1_ops.bucket_reduce`. The notes at the
top of the two sources say what bounds each kernel on the card.

Build: at first use `nvcc` compiles each source for sm_90a, both at once,
and links the two objects into one shared library with a plain C
interface in `_build/` beside this package (listed in .gitignore);
`ctypes` loads it. The library's name carries a hash of the sources and
flags, so an edit rebuilds.

Wrappers take the kernel layout, int32 tensors that hold u32 limbs
(`limbs.to_u32_layout`): [3, 12, M] Jacobian, [2, 12, M] affine, a bool[M]
mask, and for the MSM the table as rows [W N, 2, 12] with int32 `order`
and `bstart`, all contiguous on one CUDA device. They allocate the output
with `torch.empty`, launch on the current stream, raise when the launch
fails, and count their launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("g1.cu", "msm.cu")
HEADERS = ("fp.cuh", "g1.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NL = 12  # 32-bit limbs per Fp element in the kernel layout
MAX_C = 12  # window bits the MSM kernels take (auto_window picks 4, 8, 12)
MAX_GROUPS = 32  # lane groups g1_bucket_reduce sums in its last block
# g1_bucket_reduce keeps a block's 3 * 2^(c-1) points of 144 bytes in
# shared memory when they fit beside its 32 group sums in a block's 227 KB
_SMEM_PER_BLOCK = 232448
_POINT_BYTES = 144

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in SOURCES + HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liblwkzg_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernels if these sources have no library yet.

    Returns {"library", "seconds", "built", "log"}; `log` holds nvcc's
    output, including ptxas' register and spill report."""
    lib_path = _library_path()
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
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib_path)
    return {"library": lib_path, "seconds": seconds, "built": True, "log": log}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["library"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.lwkzg_g1_madd.argtypes = [vp, vp, vp, vp, ci, vp]
            lib.lwkzg_g1_add.argtypes = [vp, vp, vp, ci, vp]
            lib.lwkzg_g1_dbl.argtypes = [vp, vp, ci, vp]
            lib.lwkzg_g1_bucket_accumulate.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
            lib.lwkzg_g1_bucket_reduce.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
            fns = {
                "madd": lib.lwkzg_g1_madd, "add": lib.lwkzg_g1_add, "dbl": lib.lwkzg_g1_dbl,
                "bucket_accumulate": lib.lwkzg_g1_bucket_accumulate,
                "bucket_reduce": lib.lwkzg_g1_bucket_reduce,
            }
            for fn in fns.values():
                fn.restype = ci
            _lib = fns
    return _lib


def _check(t: torch.Tensor, name: str, shape, device, dtype=torch.int32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_window(c: int, groups: int) -> None:
    if not 1 <= c <= MAX_C:
        raise ValueError(f"window bits c must be in [1, {MAX_C}], got {c}")
    if not 1 <= groups <= MAX_GROUPS or groups & (groups - 1):
        raise ValueError(f"groups must be a power of two in [1, {MAX_GROUPS}], got {groups}")


def _run(name: str, t: torch.Tensor, *args) -> None:
    """Launch on t's device and its current stream (the last argument)."""
    fn = _load()[name]
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lwkzg_g1_{name} launch failed: cudaError {rc}")


class _Kernel:
    """A kernel wrapper with a plain-integer launch count."""

    def __init__(self, name: str, replaces: str, launch):
        self.name = name
        self.replaces = replaces
        self._launch = launch
        self.launches = 0

    def __call__(self, *args):
        return self._launch(self, *args)


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


def _bucket_accumulate(k: _Kernel, table: torch.Tensor, order: torch.Tensor,
                       bstart: torch.Tensor, c: int, groups: int):
    """table [W N, 2, 12] affine rows; order [B, W N] member indices in
    digit-sorted order, each in [0, W N); bstart [B, 2^c] non-decreasing
    run starts in [0, W N] (as `torch.sort` and `torch.searchsorted` give
    them) -> buckets [3, 12, B G 2^c]."""
    _check_window(c, groups)
    dev = table.device
    n_members = table.shape[0]
    _check(table, "table", (n_members, 2, NL), dev)
    if table.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    b = order.shape[0]
    _check(order, "order", (b, n_members), dev)
    _check(bstart, "bstart", (b, 1 << c), dev)
    m = b * groups << c
    out = torch.empty((3, NL, m), dtype=torch.int32, device=dev)
    if m and n_members:
        _run("bucket_accumulate", table, table.data_ptr(), order.data_ptr(), bstart.data_ptr(),
             out.data_ptr(), n_members, c, groups, b)
        k.launches += 1
    else:
        out.zero_()
    return out


def _reduce_in_shared_memory(c: int) -> bool:
    """Whether g1_bucket_reduce holds a block's points in shared memory."""
    return (3 << (c - 1)) * _POINT_BYTES + MAX_GROUPS * _POINT_BYTES + 16 <= _SMEM_PER_BLOCK


def _bucket_reduce(k: _Kernel, buckets: torch.Tensor, c: int, groups: int):
    """buckets [3, 12, B G 2^c] -> [3, 12, B]: per blob, the fold reduce
    of each group's buckets and the pairwise sum of its G group sums."""
    _check_window(c, groups)
    dev = buckets.device
    m = buckets.shape[-1]
    per_blob = groups << c
    if m % per_blob:
        raise ValueError(f"bucket lanes ({m}) must be a multiple of groups * 2^c = {per_blob}")
    b = m // per_blob
    _check(buckets, "buckets", (3, NL, m), dev)
    out = torch.empty((3, NL, b), dtype=torch.int32, device=dev)
    if b:
        group_sums = torch.empty((b * groups, 3 * NL), dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.int32, device=dev)
        scratch = None
        if not _reduce_in_shared_memory(c):
            scratch = torch.empty((b * groups, 3 << (c - 1), 3 * NL), dtype=torch.int32, device=dev)
        _run("bucket_reduce", buckets, buckets.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             group_sums.data_ptr(), done.data_ptr(), out.data_ptr(), c, groups, b)
        k.launches += 1
    return out


_V2 = "lambdaworks_kzg_tpu/ops/pallas_g1_v2.py"
madd = _Kernel("g1_madd", f"{_V2}:353", _madd)
add = _Kernel("g1_add", f"{_V2}:376", _add)
dbl = _Kernel("g1_dbl", f"{_V2}:392", _dbl)
# the madd of the lock-step rounds (lambdaworks_kzg_tpu/ops/msm.py:787-852)
bucket_accumulate = _Kernel("g1_bucket_accumulate", f"{_V2}:353", _bucket_accumulate)
# the add of the fold reduce and group tree (ops/msm.py:598-621, :447-477)
bucket_reduce = _Kernel("g1_bucket_reduce", f"{_V2}:376", _bucket_reduce)
ALL = (madd, add, dbl, bucket_accumulate, bucket_reduce)


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
