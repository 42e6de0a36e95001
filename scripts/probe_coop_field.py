#!/usr/bin/env python3
"""Latency probe of the cooperative field against fp.cuh on the card.

    python3 scripts/probe_coop_field.py

Builds scripts/probe_coop_field.cu with nvcc (sm_90a) into a temporary
directory and prints ptxas' register report, then times chains of 256
dependent operations per element (fp::mul,
fp::add, fpc::mul, fpc::add, one shuffle, one carry resolution) at 128
and 4096 elements with CUDA events. Prints the card's name and power
limit and one JSON line: ns per operation of one chain, and the cycles at
the SM clock nvidia-smi reports.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("fp_mul", "fp_add", "fpc_mul", "fpc_add", "shfl", "carry")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_coop_field: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from lambdaworks_kzg_tpu_torch.ops import kernels

    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    lib = os.path.join(tmp, "probe.so")
    nvcc = kernels.find_nvcc()
    src = os.path.join(HERE, "scripts", "probe_coop_field.cu")
    proc = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
                          capture_output=True, text=True)
    print("\n".join(l for l in (proc.stdout + proc.stderr).splitlines()
                    if "registers" in l or "spill" in l or "error" in l), flush=True)
    if proc.returncode:
        print(proc.stderr[-4000:])
        return 1
    so = ctypes.CDLL(lib)
    so.probe_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    so.probe_chain.restype = ctypes.c_int
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.strip().splitlines()
    mhz = float(clock[0]) if clock and clock[0].replace(".", "").isdigit() else None
    n = 256
    out = {"sm_clock_mhz": mhz, "chain": n}
    for M in (128, 4096):
        g = torch.Generator().manual_seed(M)
        a = torch.randint(0, 1 << 30, (12, M), generator=g, dtype=torch.int32).cuda()
        a[11] &= 0x0FFFFFFF  # below p
        o = torch.empty((12, M), dtype=torch.int32, device="cuda")
        for which, name in enumerate(NAMES):
            stream = torch.cuda.current_stream().cuda_stream
            rc = so.probe_chain(which, a.data_ptr(), o.data_ptr(), M, n, stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError {rc}")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                so.probe_chain(which, a.data_ptr(), o.data_ptr(), M, n, stream)
            end.record()
            torch.cuda.synchronize()
            ns = start.elapsed_time(end) / 3 / n * 1e6
            out[f"{name}_M{M}_ns"] = ns
            if mhz:
                out[f"{name}_M{M}_cycles"] = ns * mhz / 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
