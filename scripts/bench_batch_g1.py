#!/usr/bin/env python3
"""Time the batched G1 kernels on the card at the shapes of the setup
conversion and of batch verification, in the mode the conversion of the
tree under test uses, and the conversion's device part.

    python3 scripts/bench_batch_g1.py [--root DIR]

--root points at a checkout of the port (default: this repository), so
one call can time an older tree beside this one: unpack it with
`git archive <commit> lambdaworks_kzg_tpu_torch cache/srs_mainnet.npz
testdata/trusted_setup.txt | tar -x -C _checkout/parent` and run parent,
change, change, parent. A tree whose `ops/g1_batch.py` has
`scalar_mul_in_g1` converts through the split mode (two 128-bit halves
through the endomorphism); an older one through the general per-lane
double-and-add. Shapes:
  - g1_decompress on 4096 mainnet monomial x's (a conversion), 128 and 12
    (the batch verifications of 64 and 6 blobs);
  - g1_scalar_mul on an FFT stage: 2048 mainnet monomial points and the
    real twiddles of the inverse FFT's last stage (n = 4096), alone and
    followed by the two g1_add launches of the butterflies on 2048 lanes
    (a stage as trees without g1_fft_stage run it);
  - g1_fft_stage, where the tree has it, on the 4096 points at the
    inverse FFT's first (l = 2) and last (l = 4096) stage;
  - g1_scalar_mul of [1/n] on 4096 points, one scalar on every lane;
  - g1_subgroup_mask on 4096 points, 128 and 12;
  - the conversion's device part (decompression, subgroup check and
    inverse FFT of the mainnet file's 4096 G1 points, as the tree's
    `_convert_g1` runs it), host clock to a synchronize, three times
    after one warm run.
Kernel times are CUDA events over repeated launches queued behind a spin
on the card. Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # clock cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_part(srs, g1_batch, g1_bytes, dev):
    """The conversion's device part as the tree runs it: srs.convert_g1_device
    where the tree has it, else the steps of its `_convert_g1` up to the FFT."""
    import torch

    if hasattr(srs, "convert_g1_device"):
        return srs.convert_g1_device(g1_bytes, dev)
    pts, is_inf, err = g1_batch.decompress_batch(list(g1_bytes), device=dev)
    if err.any():
        raise AssertionError("a setup point failed to decompress")
    jac = g1_batch.lift_affine(pts, torch.from_numpy(~is_inf).to(dev))
    return jac, g1_batch.g1_fft_device(jac, inverse=True, in_g1=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bench_batch_g1: CUDA is not available", file=sys.stderr)
        return 2
    from lambdaworks_kzg_tpu_torch.constants import R, fr_root_of_unity
    from lambdaworks_kzg_tpu_torch.models import srs
    from lambdaworks_kzg_tpu_torch.ops import g1_batch, g1_ops, kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build()
    dev = torch.device("cuda", 0)
    setup = srs.load_mainnet_setup()
    aff, valid = g1_ops.make_points_host(setup.g1_monomial)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, dev), torch.from_numpy(valid).to(dev)).contiguous()
    jac32 = lb.to_u32_layout(jac)
    n = jac.shape[-1]
    w = pow(fr_root_of_unity(n), R - 2, R)  # the inverse FFT's last stage
    tw = [1] * (n // 2)
    for j in range(1, n // 2):
        tw[j] = tw[j - 1] * w % R
    n_inv = pow(n, R - 2, R)
    split = hasattr(g1_batch, "scalar_mul_in_g1")
    stage32 = jac32[:, :, : n // 2].contiguous()
    if split:
        k_stage = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_limbs(tw), dev))
        k_inv = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_limbs([n_inv]), dev))
        stage = lambda: kernels.scalar_mul(stage32, k_stage, 128, split=True)  # noqa: E731
        inv = lambda: kernels.scalar_mul(jac32, k_inv, 128, split=True)  # noqa: E731
    else:
        k_stage = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs(tw, 16), dev))
        k_inv = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs([n_inv], 16), dev))
        stage = lambda: kernels.scalar_mul(stage32, k_stage, 256)  # noqa: E731
        inv = lambda: kernels.scalar_mul(jac32, k_inv, n_inv.bit_length())  # noqa: E731
    out = {"root": os.path.relpath(root, HERE), "card": card,
           "scalar_mul_mode": "split" if split else "general"}
    x32 = lb.to_u32_layout(lb.as_limb_tensor(FP.to_mont_host([pt[0] for pt in setup.g1_monomial]), dev))
    want = torch.arange(n, device=dev) % 3 == 0
    for lanes in (4096, 128, 12):
        xs, ws = x32[:, :lanes].contiguous(), want[:lanes].contiguous()
        out[f"decompress_{lanes}_ms"] = time_ms(lambda: kernels.decompress(xs, ws), args.reps * 2)
    out["scalar_mul_fft_stage_2048_ms"] = time_ms(stage, args.reps)
    even32 = jac32[:, :, n // 2 :].contiguous()
    t32 = stage()

    def stage_and_adds():
        stage()
        kernels.add(even32, t32)
        kernels.add(even32, t32)

    out["scalar_mul_and_two_adds_2048_ms"] = time_ms(stage_and_adds, args.reps)
    if hasattr(kernels, "fft_stage"):
        split_stages, _ = g1_batch._split_twiddles(n, True)
        for length in (2, n):
            k32 = lb.to_u32_layout(lb.as_limb_tensor(split_stages[length.bit_length() - 2], dev))
            out[f"fft_stage_l{length}_ms"] = time_ms(lambda: kernels.fft_stage(jac32, length, k32),
                                                     args.reps)
    out["scalar_mul_inv_n_4096_ms"] = time_ms(inv, args.reps)
    for lanes in (4096, 128, 12):
        p = jac32[:, :, :lanes].contiguous()
        out[f"subgroup_mask_{lanes}_ms"] = time_ms(lambda: kernels.subgroup_mask(p), args.reps * 2)
    with open(srs.MAINNET_SETUP_PATH, "r", encoding="utf-8") as f:
        g1_bytes, _ = srs._parse_setup_text(f.read())
    device_part(srs, g1_batch, g1_bytes, dev)
    out["convert_device_s"] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_part(srs, g1_batch, g1_bytes, dev)
        torch.cuda.synchronize()
        out["convert_device_s"].append(time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
