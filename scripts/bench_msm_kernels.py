#!/usr/bin/env python3
"""Time the fixed-base MSM's two kernels on the card at the commit path's
shapes (the mainnet table, c = 8), and the generic MSM's combine
(g1_window_combine) at c = 4, 8 and 12 for 255-bit scalars and B = 1, 3,
for the tree under test.

    python3 scripts/bench_msm_kernels.py [--root DIR] [--chunks 4,8,16] [--reps N]
                                         [--only msm|combine]

--root points at a checkout of the port (default: this repository), so
one call can time an older tree beside this one: unpack it with
`git archive <commit> lambdaworks_kzg_tpu_torch cache/fixedbase_62bcf72bba2b37b8_c8.npz
cache/srs_mainnet.npz | tar -x -C _checkout/parent` and run parent, change,
change, parent. Blobs: seeded random ones at B = 1 and 6, and at B = 1 a
blob of 4096 elements 0x0101..01 (all 131,072 members in bucket 1) and
one of 4096 ones (4096 members in bucket 1, the rest in bucket 0).

A tree with the chunked schedule (`g1_ops.accumulate_chunks`) is timed at
every chunk length of --chunks (both kernels); an older tree at its lane
groups (8). Each shape also gets the whole `msm.msm_fixedbase_device`
(sort, accumulation, reduce) at the tree's defaults. Kernel times are CUDA events over repeated launches
queued behind a spin on the card (the reduce runs its merge in place, so
its later calls merge merged sums: the same adds). Prints the card's name
and power limit, then one JSON line.

The combine's window sums are the table's points, lifted, every other one
doubled (Z != 1), all finite; it is timed on the tree's own schedule.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXEDBASE = os.path.join("cache", "fixedbase_62bcf72bba2b37b8_c8.npz")
C = 8


def repo_profiling():
    """This repository's `utils/profiling.py`, loaded by its path without
    importing the package: the timed tree (--root) may be older and lack
    its `time_ms`, and its own package is imported afresh after this."""
    path = os.path.join(HERE, "lambdaworks_kzg_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("repo_profiling", path)
    profiling = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiling)
    return profiling


time_ms = repo_profiling().time_ms


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--chunks", default="4,8,16")
    parser.add_argument("--only", choices=("msm", "combine"))
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_msm_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from lambdaworks_kzg_tpu_torch import convert
    from lambdaworks_kzg_tpu_torch.ops import codec, dispatch, g1_ops, kernels, limbs as lb, msm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build()
    dev = torch.device("cuda", 0)
    table16, table_valid = convert.fixedbase_from_npz(os.path.join(root, FIXEDBASE), dev)
    rows = dispatch.to_table_layout(table16)
    n_members = rows.shape[0]
    chunked = hasattr(g1_ops, "accumulate_chunks")
    rng = np.random.default_rng(20)

    def scalars_of(blobs):
        return lb.as_limb_tensor(np.stack([codec.blob_to_limbs(b, 4096) for b in blobs]), dev)

    def members(scalars):
        digits = msm.fixedbase_digits(scalars, C)
        return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), C)

    shapes = {
        "random_b1": [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096))],
        "random_b6": [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(6)],
        "0x0101_b1": [bytes([1]) * 32 * 4096],
        "ones_b1": [(1).to_bytes(32, "little") * 4096],
    }
    out = {"root": os.path.relpath(root, HERE), "card": card, "chunked": chunked}
    for name, blobs in shapes.items() if args.only != "combine" else ():
        scalars = scalars_of(blobs)
        order, bstart = members(scalars)
        row = {}
        if chunked:
            for chunk in (int(x) for x in args.chunks.split(",")):
                acc = time_ms(lambda: kernels.bucket_accumulate(rows, order, bstart, C, chunk),
                              args.reps)
                partials = kernels.bucket_accumulate(rows, order, bstart, C, chunk)
                red = time_ms(lambda: kernels.bucket_reduce(partials, bstart, C, chunk, n_members),
                              args.reps)
                row[f"L{chunk}"] = {"accumulate_ms": acc, "reduce_ms": red}
        else:
            reps = 1 if name.startswith("0x0101") else args.reps  # ~16k madds a lane there
            acc = time_ms(lambda: kernels.bucket_accumulate(rows, order, bstart, C, 8), reps,
                          warm=1)
            buckets = kernels.bucket_accumulate(rows, order, bstart, C, 8)
            red = time_ms(lambda: kernels.bucket_reduce(buckets, C, 8), args.reps)
            row["G8"] = {"accumulate_ms": acc, "reduce_ms": red}
        row["msm_fixedbase_device_ms"] = time_ms(
            lambda: msm.msm_fixedbase_device(rows, table_valid, scalars, C), max(1, args.reps // 2),
            warm=1)
        out[name] = row
        print(name, json.dumps(row), flush=True)
    if args.only != "msm":
        out["combine"] = time_combine(table16[..., table_valid], args, dev)
    print(json.dumps(out), flush=True)
    return 0


def time_combine(table16, args, dev) -> dict:
    """g1_window_combine at c = 4, 8, 12 (255-bit windows) and B = 1, 3 on
    finite sums, on the tree's schedule -> {"c4_b1": {"windows", "ms"}, ...}."""
    import torch
    from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb

    gen = torch.Generator().manual_seed(22)
    out = {}
    for c in (4, 8, 12):
        w = -(-255 // c)
        for msms in (1, 3):
            lanes = msms * w
            pick = torch.randint(0, table16.shape[-1], (lanes,), generator=gen).to(dev)
            jac = g1_ops.lift(table16[:, :, pick], torch.ones(lanes, dtype=torch.bool, device=dev))
            jac = torch.where((torch.arange(lanes, device=dev) % 2 == 0)[None, None], g1_ops.dbl(jac), jac)
            sums = lb.to_u32_layout(jac.contiguous())
            row = {"windows": w, "ms": time_ms(lambda: kernels.window_combine(sums, c, w), args.reps)}
            out[f"c{c}_b{msms}"] = row
            print(f"combine c={c} B={msms}", json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
