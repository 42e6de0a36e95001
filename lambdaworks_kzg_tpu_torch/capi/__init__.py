"""The port's C ABI: the c-kzg-4844 minimal interface (`c_kzg_4844.h`),
implemented by `shim.c` over `lambdaworks_kzg_tpu_torch.capi_adapter`.

`build()` compiles the shim at first use, with the system C compiler
(`cc -O2 -fPIC -shared`, or $CC) and the running Python's include and
link flags from `sysconfig`, into
`lambdaworks_kzg_tpu_torch/_build/liblambdaworks_kzg_tpu_torch.so`; it
rebuilds when a source is newer than the library. The library holds no
CUDA code: it calls Python, and Python calls the kernels.

In a running Python, load it with `ctypes.CDLL(build()["library"])`. A C
program links it (`build_client` builds `kzg_client.c`, a small one) and
runs with `client_env()`'s PYTHONPATH: the repository root and this
interpreter's site directories, where the embedded interpreter finds
torch. `client_blob(seed, n)` is the blob that `kzg_client <setup> <seed>`
commits to. Contexts run on the card; LWKZG_BACKEND=host puts them on the
CPU. `build_fuzz` builds the fuzz harness `fuzz/fuzz_capi.c` the same way.
"""

import hashlib
import os
import site
import subprocess
import sysconfig
import time

CAPI_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(CAPI_DIR))
BUILD_DIR = os.path.join(os.path.dirname(CAPI_DIR), "_build")
LIBRARY = os.path.join(BUILD_DIR, "liblambdaworks_kzg_tpu_torch.so")
HEADER = os.path.join(CAPI_DIR, "c_kzg_4844.h")
SHIM = os.path.join(CAPI_DIR, "shim.c")
CLIENT = os.path.join(CAPI_DIR, "kzg_client.c")
FUZZ = os.path.join(os.path.dirname(CAPI_DIR), "fuzz", "fuzz_capi.c")
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")


def _python_flags():
    """(compile flags, link flags) for this interpreter: its headers, and
    where it has a shared libpython, that library with an rpath to it."""
    cflags = ["-I", sysconfig.get_config_var("INCLUDEPY")]
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return cflags, []
    libdir = sysconfig.get_config_var("LIBDIR")
    name = sysconfig.get_config_var("LDLIBRARY")  # e.g. libpython3.12.so
    return cflags, ["-L", libdir, "-l" + name[3:].split(".so")[0], "-Wl,-rpath," + libdir]


def _compile(target: str, sources, args) -> dict:
    """Run the C compiler into `target` unless it is newer than every one of
    `sources`; -> {"path", "seconds", "built"}."""
    if os.path.exists(target) and all(os.path.getmtime(s) <= os.path.getmtime(target)
                                      for s in sources):
        return {"path": target, "seconds": 0.0, "built": False}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([os.environ.get("CC", "cc"), *args, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return {"path": target, "seconds": time.perf_counter() - t0, "built": True}


def build() -> dict:
    """Compile the shim if it has no up-to-date library yet; -> {"library",
    "seconds", "built"}."""
    cflags, ldflags = _python_flags()
    out = _compile(LIBRARY, (SHIM, HEADER),
                   ["-O2", "-fPIC", "-shared", "-Wall", *cflags, "-I", CAPI_DIR, SHIM, *ldflags])
    return {"library": out["path"], "seconds": out["seconds"], "built": out["built"]}


def build_client(field_elements: int = 4096) -> dict:
    """Compile `kzg_client.c` for setups of `field_elements` G1 points
    against the library (built first); -> {"path", "seconds", "built"}.
    A C program embeds the interpreter, so this needs a shared libpython."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("this Python has no shared libpython for a C program to embed")
    build()
    _, ldflags = _python_flags()
    target = os.path.join(BUILD_DIR, f"kzg_client_{field_elements}")
    return _compile(target, (CLIENT, HEADER, LIBRARY),
                    ["-O2", "-Wall", f"-DFIELD_ELEMENTS_PER_BLOB={field_elements}", "-I", CAPI_DIR,
                     CLIENT, "-L", BUILD_DIR, "-llambdaworks_kzg_tpu_torch", "-Wl,-rpath," + BUILD_DIR,
                     *ldflags])


def build_fuzz(target=None) -> dict:
    """Compile `fuzz/fuzz_capi.c` in its replay mode (-DSTANDALONE_REPLAY,
    for gcc) against the library (built first), on the degree-4 setup
    (`testdata/trusted_setup_4.txt`, 4-element blobs): the combined
    first-byte target, or with target = 0..5 the dedicated target of one
    entry point (the order of `fuzz/gen_corpus.FNS`) -> {"path",
    "seconds", "built"}. Run it with `client_env()` on corpus files: it
    exits 1 when a call returns C_KZG_ERROR or C_KZG_MALLOC."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("this Python has no shared libpython for a C program to embed")
    if target is not None and target not in range(6):
        raise ValueError(f"the dedicated targets are 0..5, got {target}")
    build()
    _, ldflags = _python_flags()
    defines = ["-DSTANDALONE_REPLAY", "-DN_FIELD=4", "-DFIELD_ELEMENTS_PER_BLOB=4",
               f'-DTRUSTED_SETUP_PATH="{SETUP_4}"']
    if target is not None:
        defines.append(f"-DFUZZ_TARGET={target}")
    # the name carries the defines, so a checkout moved to another path builds anew
    tag = hashlib.sha256(" ".join(defines).encode()).hexdigest()[:8]
    out = os.path.join(BUILD_DIR, f"fuzz_capi_{'combined' if target is None else target}_{tag}")
    return _compile(out, (FUZZ, HEADER, LIBRARY),
                    ["-O2", "-Wall", *defines, "-I", CAPI_DIR, FUZZ, "-L", BUILD_DIR,
                     "-llambdaworks_kzg_tpu_torch", "-Wl,-rpath," + BUILD_DIR, *ldflags])


def client_env(env=None) -> dict:
    """`env` (default: this process's) with PYTHONPATH set to the repository
    root and this interpreter's site directories, ahead of what it held."""
    env = dict(os.environ if env is None else env)
    paths = [REPO, *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def client_blob(seed: int, n: int = 4096) -> bytes:
    """The blob `kzg_client` makes from `seed`: element i is the next 31
    bytes of a splitmix64 stream (each word least significant byte
    first) and a zero top byte."""
    mask = (1 << 64) - 1
    state, stream = seed & mask, bytearray()
    while len(stream) < 31 * n:
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        stream += (z ^ (z >> 31)).to_bytes(8, "little")
    return b"".join(bytes(stream[31 * i : 31 * i + 31]) + b"\x00" for i in range(n))
