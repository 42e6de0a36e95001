#!/usr/bin/env python3
"""Run the port's native-tier tests against the tier built with
AddressSanitizer and UndefinedBehaviorSanitizer (the port's counterpart of
`make native-asan`).

It builds `lambdaworks_kzg_tpu_torch/csrc/native/bls12_381.cpp` with
`native.ASAN_CXXFLAGS` (-O1 -g, -fsanitize=address,undefined,
-fno-sanitize-recover=all) into `lambdaworks_kzg_tpu_torch/_build/`
under its own digest name, and the -O3 library beside it (one test
checks that build), then runs `python -m pytest
tests/test_torch_native.py -m "not slow"` in a subprocess with

    LWKZG_NATIVE_LIB=<the sanitizer build>
    LD_PRELOAD="$($CXX -print-file-name=libasan.so) $($CXX -print-file-name=libstdc++.so.6)"
    ASAN_OPTIONS=detect_leaks=0 (CPython keeps its interned objects)

and exits with the subprocess's code. Any sanitizer report aborts the
process, so the tests fail. libstdc++ comes right after the ASan runtime
because the interpreter does not link it: without it ASan's
`__cxa_throw` interceptor finds no real function and aborts at the first
C++ exception of an extension (jaxlib throws one while the tests' JAX
side compiles). The JAX package's native tier also reads
LWKZG_NATIVE_LIB, so the tests' JAX comparisons load the same build.
Run from anywhere:

    python3 scripts/torch_native_asan.py [extra pytest arguments]
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lambdaworks_kzg_tpu_torch import native  # noqa: E402


def main(argv) -> int:
    native.build()
    lib = native.build(flags=native.ASAN_CXXFLAGS)["library"]
    cxx = os.environ.get("CXX") or "g++"
    preload = []
    for name in ("libasan.so", "libstdc++.so.6"):
        path = subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True, text=True,
                              check=True).stdout.strip()
        if not os.path.isabs(path) or not os.path.exists(path):
            print(f"torch_native_asan: {cxx} has no {name} ({path!r})", file=sys.stderr)
            return 2
        preload.append(os.path.realpath(path))
    env = dict(os.environ, LWKZG_NATIVE_LIB=lib, LD_PRELOAD=" ".join(preload),
               ASAN_OPTIONS=os.environ.get("ASAN_OPTIONS") or "detect_leaks=0")
    env.pop("LWKZG_NATIVE", None)
    cmd = [sys.executable, "-m", "pytest", "tests/test_torch_native.py", "-q", "-m", "not slow",
           "-p", "no:cacheprovider", *argv]
    print(f"LWKZG_NATIVE_LIB={lib} LD_PRELOAD='{env['LD_PRELOAD']}' "
          f"ASAN_OPTIONS={env['ASAN_OPTIONS']} " + " ".join(cmd), flush=True)
    return subprocess.run(cmd, cwd=REPO, env=env).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
