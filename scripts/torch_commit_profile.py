#!/usr/bin/env python3
"""Where the time of mainnet commits goes, on a CUDA card.

Builds EIP4844Context(mainnet setup, device="cuda"), commits seeded random
blobs to warm up, then profiles two windows under torch.profiler: three
single commits (`blob_to_kzg_commitment`) and one batch of six
(`blob_to_kzg_commitment_batch`). For each it prints the device time by
kernel, the host wall time, the share of that wall time the card was busy
(the sum of device-side kernel and copy times over the wall time), and the
host operators that took the most time. Without the profiler it then times
the stages of single commits on the host clock, each ended by a
synchronize: blob checks and transfer, the MSM on the card, and the result's
transfer and compression. Run from the repository root:

    python3 scripts/torch_commit_profile.py

The last line is one JSON object with the numbers of both windows and
the stages.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def window(prof, wall_ms: float, blobs: int) -> dict:
    """Device rows (an operator's row repeats its kernels' time, so only
    device-side events are summed) and the top host operators."""
    dev_rows, host_rows = [], []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                dev_rows.append((dev_us / 1e3, ev.count, ev.key))
        elif ev.self_cpu_time_total > 0:
            host_rows.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
    dev_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in dev_rows)
    return {
        "blobs": blobs,
        "wall_ms_per_blob": wall_ms / blobs,
        "device_busy_ms_per_blob": busy_ms / blobs,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "device": [{"kernel": k[:120], "ms": ms, "count": n} for ms, n, k in dev_rows[:10]],
        "host": [{"op": k[:120], "self_ms": ms, "count": n} for ms, n, k in host_rows[:10]],
    }


def show(name: str, w: dict) -> None:
    print(f"{name}: {w['blobs']} blobs, wall {w['wall_ms_per_blob']:.3f} ms/blob, device busy "
          f"{w['device_busy_ms_per_blob']:.3f} ms/blob, busy share {w['device_busy_share']:.3f}")
    for row in w["device"]:
        print(f"  device {row['ms']:9.3f} ms  {row['count']:6d} x  {row['kernel'][:90]}")
    for row in w["host"][:6]:
        print(f"  host   {row['self_ms']:9.3f} ms  {row['count']:6d} x  {row['op'][:90]}")


def main() -> int:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_commit_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from lambdaworks_kzg_tpu_torch import EIP4844Context, load_mainnet_setup
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, msm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    ctx = EIP4844Context(load_mainnet_setup(), device="cuda")
    rng = np.random.default_rng(7)
    blobs = [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(10)]
    ctx.blob_to_kzg_commitment(blobs[0])
    ctx.blob_to_kzg_commitment_batch(blobs[:6])
    torch.cuda.synchronize()

    windows = {}
    for name, calls, n_blobs in (
        ("single", [lambda b=b: ctx.blob_to_kzg_commitment(b) for b in blobs[1:4]], 3),
        ("batch6", [lambda: ctx.blob_to_kzg_commitment_batch(blobs[4:10])], 6),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for call in calls:
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        windows[name] = window(prof, wall_ms, n_blobs)
    backend = ctx.backend
    stages = {"blob_checks_and_transfer": [], "msm_on_card": [], "result_and_compress": []}
    for blob in blobs[1:6]:
        t0 = time.perf_counter()
        scalars = backend.blob_scalars([blob])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pt = msm.msm_fixedbase_device(backend._table, backend._table_valid, scalars, backend.c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        HC.compress_g1(g1_ops.points_to_host(dispatch.from_op_layout(pt))[0])
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    print(card)
    for name, w in windows.items():
        show(name, w)
    print("stages of single commits (ms):", {k: [round(x, 3) for x in v] for k, v in stages.items()})
    print(json.dumps({"card": card, **windows, "stages_ms": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
