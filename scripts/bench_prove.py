#!/usr/bin/env python3
"""Time whole proofs and a proof's Fr part on the mainnet setup, on one
card, for this tree or another checkout of the port.

    python3 scripts/bench_prove.py [--root DIR] [--reps N]

--root points at a checkout of the port (default: this repository), so
one call can time an older tree beside this one: unpack it with
`git archive <commit> lambdaworks_kzg_tpu_torch cache testdata | tar -x
-C _checkout/parent` and run parent, change, change, parent, each in a
process of its own. After a warm-up it measures:
  - `compute_blob_kzg_proof` on seeded blobs, host clock from the call to
    the proof's bytes, `reps` calls;
  - `compute_blob_kzg_proof_batch` of 6 blobs, ms per proof, `reps` calls;
  - `blob_to_kzg_commitment` on one blob and `blob_to_kzg_commitment_batch`
    of 6 (ms a blob), host clock, `reps` calls each;
  - one proof and one commitment under torch.profiler (kernels, copies,
    device busy);
  - `compute_kzg_proof` at a root of unity (z = w_1, the in-domain
    quotient), host clock, `reps` calls;
  - `TorchBackend.open_scalars` on one blob's limbs already on the card
    (the Fr part, the MSM and the proof's transfer, without the blob's
    checks and the challenge), host clock, `reps` calls;
  - `TorchBackend.evaluate_blobs` of 64 blobs (a batch verification's
    evaluate stage: the blobs' checks and transfer, the evaluation, y
    back), host clock, `reps` calls;
  - the Fr part of a batch of 1 and of 6 as the tree's
    `TorchBackend.open_scalars` runs it (`FrDomain.open_mont`): CUDA
    events around it after a synchronize (`fr_ms`, the host's enqueue
    included), and under torch.profiler (kernels, copies, device busy),
    both read with `events_ms` and `device_work` of this repository's
    `utils/profiling.py`, whichever tree is timed;
  - where the tree's `FrDomain` has `z_table`, that table's host time
    alone (build and transfer, to a synchronize);
  - the Fr part of a proof at z = w_1 as the tree's `FrDomain.quotient`
    runs it on one blob's plain limbs, the same way (`fr.root`).
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_profiling():
    """This repository's `utils/profiling.py`, loaded by its path without
    importing the package: the timed tree (--root) may be older and lack
    the readers, and its own package is imported afresh after this."""
    path = os.path.join(HERE, "lambdaworks_kzg_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("repo_profiling", path)
    profiling = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profiling)
    return profiling


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    root_dir = os.path.abspath(args.root)
    profiling = repo_profiling()
    device_work, events_ms = profiling.device_work, profiling.events_ms

    def host_ms(fn, reps):
        return profiling.host_ms(fn, reps)[1]

    sys.path.insert(0, root_dir)
    import torch

    from lambdaworks_kzg_tpu_torch import EIP4844Context
    from lambdaworks_kzg_tpu_torch.models.srs import load_mainnet_setup

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    ctx = EIP4844Context(load_mainnet_setup(), device="cuda")
    rng = random.Random(18)
    blobs = [b"".join(rng.randbytes(31) + b"\x00" for _ in range(4096)) for _ in range(6)]
    commitments = ctx.blob_to_kzg_commitment_batch(blobs)
    for _ in range(3):  # warm: the kernels' build and first launches
        ctx.compute_blob_kzg_proof(blobs[0], commitments[0])
        ctx.compute_blob_kzg_proof_batch(blobs, commitments)
    single = host_ms(lambda: ctx.compute_blob_kzg_proof(blobs[1], commitments[1]), args.reps)
    batch = [t / 6 for t in host_ms(lambda: ctx.compute_blob_kzg_proof_batch(blobs, commitments),
                                     args.reps)]
    commit = host_ms(lambda: ctx.blob_to_kzg_commitment(blobs[3]), args.reps)
    commit6 = [t / 6 for t in host_ms(lambda: ctx.blob_to_kzg_commitment_batch(blobs), args.reps)]
    proof_device = device_work(lambda: ctx.compute_blob_kzg_proof(blobs[1], commitments[1]))
    commit_device = device_work(lambda: ctx.blob_to_kzg_commitment(blobs[3]))
    z_root = ctx.backend.domain.roots_brp_ints[1]
    ctx.compute_kzg_proof(blobs[0], z_root.to_bytes(32, "little"))
    at_root = host_ms(lambda: ctx.compute_kzg_proof(blobs[2], z_root.to_bytes(32, "little")), args.reps)
    backend, domain = ctx.backend, ctx.backend.domain
    zs = [rng.randrange(1 << 250) for _ in range(6)]
    one = backend.blob_scalars(blobs[:1])
    opened = host_ms(lambda: backend.open_scalars(one, zs[:1]), args.reps)
    many, many_zs = (blobs * 11)[:64], [rng.randrange(1 << 250) for _ in range(64)]
    evaluated = host_ms(lambda: backend.evaluate_blobs(many, many_zs), args.reps)
    fr = {}
    for k in (1, 6):
        scalars = backend.blob_scalars(blobs[:k])
        fn = lambda: domain.open_mont(scalars, zs[:k])  # noqa: E731
        fn()
        fr_ms = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            fr_ms.append(events_ms(fn)[1])
        fr[f"b{k}"] = {"fr_ms": fr_ms, "device": device_work(fn)}
        if hasattr(domain, "z_table"):
            def table():
                domain.z_table(zs[:k])
                torch.cuda.synchronize()
            fr[f"b{k}"]["z_table_ms"] = host_ms(table, args.reps)
    fn = lambda: domain.quotient(one[0], z_root, None)  # noqa: E731
    fn()
    root_fr_ms = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        root_fr_ms.append(events_ms(fn)[1])
    fr["root"] = {"fr_ms": root_fr_ms, "device": device_work(fn)}
    out = {"root": os.path.relpath(root_dir, HERE), "card": card,
           "proof_ms": single, "proof_ms_median": statistics.median(single),
           "root_proof_ms": at_root, "root_proof_ms_median": statistics.median(at_root),
           "batch6_ms_per_proof": batch, "batch6_ms_per_proof_median": statistics.median(batch),
           "commit_ms": commit, "commit_ms_median": statistics.median(commit),
           "commit6_ms_per_blob": commit6, "commit6_ms_per_blob_median": statistics.median(commit6),
           "proof_device": proof_device, "commit_device": commit_device,
           "open_scalars_ms": opened, "open_scalars_ms_median": statistics.median(opened),
           "evaluate64_ms": evaluated, "evaluate64_ms_median": statistics.median(evaluated),
           "fr": fr}
    for k, v in fr.items():
        print(f"{k}: fr_ms median {statistics.median(v['fr_ms']):.3f}, device {v['device']}", flush=True)
    print(f"proof median {out['proof_ms_median']:.3f} ms, at a root {out['root_proof_ms_median']:.3f} ms, "
          f"batch of 6 median "
          f"{out['batch6_ms_per_proof_median']:.3f} ms a proof, open_scalars median "
          f"{out['open_scalars_ms_median']:.3f} ms, 64 evaluations median "
          f"{out['evaluate64_ms_median']:.3f} ms; commitment median {out['commit_ms_median']:.3f} ms, "
          f"batch of 6 {out['commit6_ms_per_blob_median']:.3f} ms a blob; a proof's device work "
          f"{proof_device}, a commitment's {commit_device}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
