"""The three Hopper kernels (`csrc/g1.cu`), their build and their wrappers.

`g1_madd`, `g1_add` and `g1_dbl` replace the TPU kernels `madd`, `add`
and `dbl` of `lambdaworks_kzg_tpu/ops/pallas_g1_v2.py` (and the v1-layout
kernels of `ops/pallas_g1.py`, which compute the same function). Their
plain versions are `madd`, `add` and `dbl` of `ops/g1_ops.py`; see the
note at the top of `csrc/g1.cu` for what bounds them on the card.

Build: `nvcc` compiles `csrc/g1.cu` for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` beside this
package (listed in .gitignore); `ctypes` loads it. The library's name
carries a hash of the sources and flags, so an edit rebuilds.

Wrappers take the kernel layout, int32 tensors that hold u32 limbs
(`limbs.to_u32_layout`): [3, 12, M] Jacobian, [2, 12, M] affine and a
bool[M] mask, all contiguous on one CUDA device. They allocate the
output with `torch.empty`, launch on the current stream, raise when the
launch fails, and count their launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("g1.cu", "fp.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NL = 12  # 32-bit limbs per Fp element in the kernel layout

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
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libg1_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernels if this source has no library yet.

    Returns {"library", "seconds", "built", "log"}; `log` holds nvcc's
    output, including ptxas' register and spill report."""
    lib_path = _library_path()
    log_path = lib_path[:-3] + ".log"
    if os.path.exists(lib_path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"library": lib_path, "seconds": 0.0, "built": False, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, "g1.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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
            for fn in (lib.lwkzg_g1_madd, lib.lwkzg_g1_add, lib.lwkzg_g1_dbl):
                fn.restype = ci
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, coords: int, m: int, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (u32 limbs), got {t.dtype}")
    if tuple(t.shape) != (coords, NL, m):
        raise ValueError(f"{name} must have shape {(coords, NL, m)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _run(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


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
    _check(p, "p", 3, m, p.device)
    _check(q, "q", 2, m, p.device)
    if live.dtype != torch.bool or tuple(live.shape) != (m,):
        raise ValueError(f"live must be bool[{m}]")
    if live.device != p.device or not live.is_contiguous():
        raise ValueError("live must be contiguous on the points' device")
    out = torch.empty_like(p)
    if m:
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream().cuda_stream
            _run(_load().lwkzg_g1_madd, p.data_ptr(), q.data_ptr(),
                 live.data_ptr(), out.data_ptr(), m, stream)
        k.launches += 1
    return out


def _add(k: _Kernel, p: torch.Tensor, q: torch.Tensor):
    m = p.shape[-1]
    _check(p, "p", 3, m, p.device)
    _check(q, "q", 3, m, p.device)
    out = torch.empty_like(p)
    if m:
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream().cuda_stream
            _run(_load().lwkzg_g1_add, p.data_ptr(), q.data_ptr(),
                 out.data_ptr(), m, stream)
        k.launches += 1
    return out


def _dbl(k: _Kernel, p: torch.Tensor):
    m = p.shape[-1]
    _check(p, "p", 3, m, p.device)
    out = torch.empty_like(p)
    if m:
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream().cuda_stream
            _run(_load().lwkzg_g1_dbl, p.data_ptr(), out.data_ptr(), m, stream)
        k.launches += 1
    return out


madd = _Kernel("g1_madd", "lambdaworks_kzg_tpu/ops/pallas_g1_v2.py:353", _madd)
add = _Kernel("g1_add", "lambdaworks_kzg_tpu/ops/pallas_g1_v2.py:376", _add)
dbl = _Kernel("g1_dbl", "lambdaworks_kzg_tpu/ops/pallas_g1_v2.py:392", _dbl)
ALL = (madd, add, dbl)


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
