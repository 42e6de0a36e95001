#!/usr/bin/env python3
"""Launches and device time of one pairing check of the device pairing
tier, on a CUDA card: the two kernels (pairing_miller_loop,
pairing_final_exp) against their plain PyTorch versions
(pairing_ops.miller_loop_jac + final_exp_check) on the same inputs, and
one single verification (`verify_kzg_proof` on a vector whose points
are finite) through the default context (the device tier on a card)
and through the host tier forced with `KZGConfig(device_pairing=False)`.

The check is a verification's: B = 2 pairs, e(-[ab]G, G2) e([a]G, [b]G2)
with Z != 1. Each side runs once to warm up, then once between CUDA
events and once under torch.profiler (launches, copies, device busy).
The plain side is ~0.7 M small launches: its profile takes minutes to
read back, which is why chip_smoke.py leaves it to this script. Run
from the repository root:

    python3 scripts/pairing_profile.py

The last line is one JSON object with both sides and the card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def profiled(fn) -> dict:
    """fn() under torch.profiler -> launches, copies and device busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "busy_ms": 0.0}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        out["copies" if ev.key.startswith(("Memcpy", "Memset")) else "kernels"] += ev.count
        out["busy_ms"] += us / 1e3
    out["profile_s"] = time.perf_counter() - t0
    return out


def timed(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pairing_profile: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGConfig, load_mainnet_setup
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb, pairing_ops
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    dev = torch.device("cuda", 0)
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pairs = [(HC.point_neg(HC.point_scalar_mul(G, 13 * 29)), G2),
             (HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29))]
    ps, qs = pairing_ops.jacobian_lanes(pairs, dev, seed=2)
    ps32, qs32 = lb.to_u32_layout(ps), lb.to_u32_layout(qs)

    def kernel_check():
        return kernels.final_exp(kernels.miller_loop(ps32, qs32))[1]

    def plain_check():
        return pairing_ops.final_exp_check(pairing_ops.miller_loop_jac(ps, qs))[1]

    out = {"card": card, "pairs": 2}
    for name, fn in (("kernels", kernel_check), ("plain", plain_check)):
        if fn().tolist() != [True]:
            raise AssertionError(f"the {name} check rejected a true pairing")
        out[name] = {"ms": timed(fn), **profiled(fn)}
        print(f"{name}: {out[name]}", flush=True)

    # one verify_kzg_proof vector on each tier, host clock, after a warm
    # call; its commitment and proof are finite, so both pairs are live
    case = load_case(str(HERE / "testdata" / "consensus" / "verify_kzg_proof" / "small" /
                         "verify_kzg_proof_case_correct_proof_0d492c3b5a603435" / "data.yaml"))
    args = [case["input"][k] for k in ("commitment", "z", "y", "proof")]
    setup = load_mainnet_setup()
    ctx = EIP4844Context(setup, device="cuda", config=KZGConfig())
    # the default context on a card takes the device tier; the host tier
    # is forced
    for tier, config in (("device", KZGConfig()), ("host", KZGConfig(device_pairing=False))):
        tctx = EIP4844Context(setup, backend=ctx.backend, config=config)
        tctx.verify_kzg_proof(*args)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            if tctx.verify_kzg_proof(*args) is not True:
                raise AssertionError(f"the {tier} tier rejected a true vector")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"verify_kzg_proof_ms_{tier}"] = times
        print(f"verify_kzg_proof on the {tier} tier: {times} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
