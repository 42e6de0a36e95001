#!/usr/bin/env python3
"""Where the time of one mainnet commit goes, on a CUDA card.

Builds EIP4844Context(mainnet setup, device="cuda"), commits one seeded
random blob to warm up, then commits three more under torch.profiler and
prints the device time by kernel, the host wall time, and the share of
that wall time the card was busy. Run from the repository root:

    python3 scripts/torch_commit_profile.py

The last line is one JSON object with the numbers.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_commit_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from lambdaworks_kzg_tpu_torch import EIP4844Context, load_mainnet_setup

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    ctx = EIP4844Context(load_mainnet_setup(), device="cuda")
    rng = np.random.default_rng(7)
    blobs = [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(4)]
    ctx.blob_to_kzg_commitment(blobs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for blob in blobs[1:]:
            ctx.blob_to_kzg_commitment(blob)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: an operator's row repeats its kernels' time
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(card)
    print(f"{len(blobs) - 1} commits: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms")
    for ms, count, key in rows[:15]:
        print(f"  {ms:9.3f} ms  {count:6d} x  {key[:90]}")
    print(json.dumps({
        "card": card,
        "commits": len(blobs) - 1,
        "wall_ms_per_commit": wall_ms / (len(blobs) - 1),
        "device_busy_ms_per_commit": busy_ms / (len(blobs) - 1),
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "top": [{"kernel": key[:120], "ms": ms, "count": count} for ms, count, key in rows[:8]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
