#!/usr/bin/env python3
"""Smoke run of lambdaworks_kzg_tpu_torch on one NVIDIA card (built for H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. nvcc builds the three G1 kernels from lambdaworks_kzg_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, at the
     lane counts the main path gives it (4096 for the table build, 2048
     for the bucket grid, 1024 down to 1 in the reductions, 8 in the
     Horner step, 200 for a partly filled second block), random and
     exceptional lanes (P at infinity, P == Q, P == -Q, dead lanes): limb
     for limb;
  4. the mainnet setup (testdata/trusted_setup.txt and its committed
     conversion); EIP4844Context(setup, device="cuda") builds the
     fixed-base table with the dbl kernel, and the table must equal
     cache/fixedbase_62bcf72bba2b37b8_c8.npz bit for bit;
  5. the ten blob_to_kzg_commitment consensus vectors;
  6. three seeded random blobs through blob_to_kzg_commitment and a
     batch of six through blob_to_kzg_commitment_batch (twice), timed
     with CUDA events; one blob also through the plain PyTorch path on
     the card;
  7. each kernel timed with CUDA events at its path shape (madd at the
     bucket grid's 2048 lanes, add at the fold reduce's widest 1024,
     dbl at the table build's 4096), on random lanes.
Launch counts are zeroed just before phase 4 and read after phase 6, so
they count the main path only. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}. Any failure
ends the run with a non-zero exit and without those lines.
"""

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "lambdaworks_kzg_tpu_torch"
FIXEDBASE = os.path.join(HERE, "cache", "fixedbase_62bcf72bba2b37b8_c8.npz")
VECTORS = os.path.join(HERE, "testdata", "consensus", "blob_to_kzg_commitment", "small")

# Peak rates of one H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s, and
# 32-bit integer multiply-adds at half the fp32 FMA rate (64 vs 128 lanes
# per SM per clock): 67 TFLOP/s fp32 = 33.5 T FMA/s -> 16.75 T IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 2 / 2
# One Montgomery product (CIOS, 12 x 32-bit limbs): 144 + 144 wide
# 32x32->64 products (two IMADs each) and 12 low products for m.
IMAD_PER_FP_MUL = 2 * (144 + 144) + 12
FP_BYTES = 48
# Montgomery products per live, finite, non-doubling lane
FP_MULS = {"madd": 11, "add": 16, "dbl": 8}
# Lane counts of phase 3: every count the main path launches a kernel at
# (and 200, a block and a partial one), each holding the exceptional lanes
# its lane pattern reaches
CHECK_LANES = (1, 2, 4, 8, 16, 32, 64, 128, 200, 256, 512, 1024, 2048, 4096)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"phase {self.name}: {'ok' if exc is None else 'FAILED'} in {dt:.2f} s")
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_lanes(points, M: int, seed: int, exceptional: bool = True):
    """Random lanes from the setup's 4096 affine points (radix-2^16 int64
    on the card): p [3, 24, M] Jacobian with Z != 1 on even lanes, q
    [2, 24, M] affine, live bool[M], q3 [3, 24, M]; with `exceptional`,
    every 8 lanes also hold P or Q at infinity, P == Q, P == -Q and a
    dead lane (lanes 1, 2, 3, 5, 6 of each 8)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    g = torch.Generator().manual_seed(seed)
    n = points.shape[-1]
    pick_p = torch.randint(0, n, (M,), generator=g).to(points.device)
    pick_q = torch.randint(0, n, (M,), generator=g).to(points.device)
    lane = torch.arange(M, device=points.device)
    ones = torch.ones(M, dtype=torch.bool, device=points.device)

    a = g1_ops.lift(points[:, :, pick_p], ones)
    p = torch.where((lane % 2 == 0)[None, None], g1_ops.dbl(a), a)
    q = points[:, :, pick_q].contiguous()
    q_jac = g1_ops.lift(q, ones)
    q3 = torch.where((lane % 2 == 1)[None, None], g1_ops.dbl(q_jac), q_jac)
    if not exceptional:
        return p.contiguous(), q, ones, q3.contiguous()

    def put(arr, mask, value):
        return torch.where(mask[None, None], value, arr)

    neg_q = torch.stack([q_jac[0], FP.neg(q_jac[1]), q_jac[2]])
    p = put(p, lane % 8 == 1, torch.zeros_like(p))  # P at infinity
    p = put(p, lane % 8 == 3, q_jac)  # P == Q
    p = put(p, lane % 8 == 5, neg_q)  # P == -Q
    live = (lane % 8 != 6).contiguous()  # dead lanes
    q3 = put(q3, lane % 8 == 2, torch.zeros_like(q3))  # Q at infinity
    q3 = put(q3, lane % 8 == 3, p)  # same point
    q3 = put(q3, lane % 8 == 5, torch.stack([p[0], FP.neg(p[1]), p[2]]))  # -P
    return p.contiguous(), q, live, q3.contiguous()


def check_kernel(op: str, args16):
    """Kernel vs plain version on the same inputs -> max |limb error|."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb

    plain = getattr(g1_ops, op)(*args16)
    k_args = [lb.to_u32_layout(a) if a.dtype == torch.int64 else a for a in args16]
    got = lb.to_u16_layout(getattr(kernels, op)(*k_args))
    torch.cuda.synchronize()
    err = int((got - plain).abs().max().item())
    if err or not torch.equal(got, plain):
        bad = int((got != plain).any(dim=0).any(dim=0).sum().item())
        raise AssertionError(f"{op}: kernel differs from plain on {bad} lanes")
    return err


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA card")

    from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError, load_mainnet_setup
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import codec, g1_ops, kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_commitment_vector

    dev = torch.device("cuda", 0)
    results = {}

    with Phase("1 card"):
        card = card_line()
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    with Phase("2 build"):
        info = kernels.build()
        results["build_s"] = info["seconds"]
        log(f"nvcc build {info['seconds']:.2f} s -> {os.path.relpath(info['library'], HERE)}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    setup = load_mainnet_setup()
    points = lb.as_limb_tensor(setup.lagrange_points, dev)
    max_err = {"madd": 0, "add": 0, "dbl": 0}
    with Phase("3 kernels vs plain"):
        for M in CHECK_LANES:
            p, q, live, q3 = make_lanes(points, M, seed=M)
            for op, args in (("madd", (p, q, live)), ("add", (p, q3)), ("dbl", (p,))):
                max_err[op] = max(max_err[op], check_kernel(op, args))
                log(f"  {op} M={M}: equal to plain, limb for limb")

    kernels.reset_counts()
    with Phase("4 setup and fixed-base table"):
        t0 = time.perf_counter()
        ctx = EIP4844Context(setup, device="cuda")
        torch.cuda.synchronize()
        results["table_build_s"] = time.perf_counter() - t0
        table, valid = ctx.backend.fixedbase()
        with np.load(FIXEDBASE) as ref:
            same_table = np.array_equal(table.cpu().numpy().astype(np.uint32), ref["table"])
            same_valid = np.array_equal(valid.cpu().numpy(), ref["valid"])
        if not (same_table and same_valid):
            raise AssertionError(f"fixed-base table differs (table {same_table}, valid {same_valid})")
        log(f"  table {tuple(table.shape)} built in {results['table_build_s']:.2f} s, "
            f"bit-equal to {os.path.relpath(FIXEDBASE, HERE)}; dbl launches {kernels.dbl.launches}")

    with Phase("5 consensus vectors"):
        names = sorted(os.listdir(VECTORS))
        passed = 0
        for name in names:
            blob, want = load_commitment_vector(os.path.join(VECTORS, name, "data.yaml"))
            t0 = time.perf_counter()
            try:
                got = ctx.blob_to_kzg_commitment(blob)
            except KZGError:
                got = None
            ok = got == want
            passed += ok
            log(f"  {name}: {'ok' if ok else 'WRONG'} ({time.perf_counter() - t0:.3f} s)")
        if passed != len(names) or len(names) != 10:
            raise AssertionError(f"{passed}/{len(names)} vectors correct")
        log(f"  {passed}/{len(names)} blob_to_kzg_commitment vectors correct")

    with Phase("6 batch of six blobs"):
        rng = np.random.default_rng(4844)
        blobs = [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(6)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def timed(fn, *args):
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)

        runs = [timed(ctx.blob_to_kzg_commitment, b) for b in blobs[:3]]
        singles = [r[0] for r in runs]
        results["ms_per_blob_single"] = [r[1] for r in runs]
        runs = [timed(ctx.blob_to_kzg_commitment_batch, blobs) for _ in range(2)]
        batch = runs[0][0]
        results["ms_per_blob_batch6"] = [r[1] / len(blobs) for r in runs]
        launches = {k.name: k.launches for k in kernels.ALL}  # the main path ends here
        log(f"  single {results['ms_per_blob_single']} ms/blob, "
            f"batch of 6 {results['ms_per_blob_batch6']} ms/blob; launches {launches}")
        if singles != batch[:3] or runs[1][0] != batch or len(set(batch)) != len(batch):
            raise AssertionError("batch and single commitments disagree")
        scalars = lb.as_limb_tensor(codec.blob_to_limbs(blobs[1], 4096), dev)
        t0 = time.perf_counter()
        plain = HC.compress_g1(ctx.backend.commit_scalars(scalars, ops=g1_ops))
        log(f"  plain PyTorch path on the card: {time.perf_counter() - t0:.2f} s")
        if plain != batch[1]:
            raise AssertionError("kernel path and plain path commit differently")
        log("  blob 1: kernel path equals the plain path on the card")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel was not launched on the main path: {launches}")

    entries = []
    with Phase("7 kernel timing"):
        shapes = {"madd": 2048, "add": 1024, "dbl": 4096}
        for op, M in shapes.items():
            # random lanes: the rare exceptional lanes would make every
            # warp run the doubling branch too
            p, q, live, q3 = make_lanes(points, M, seed=7 * M, exceptional=False)
            args16 = {"madd": (p, q, live), "add": (p, q3), "dbl": (p,)}[op]
            k_args = [lb.to_u32_layout(a) if a.dtype == torch.int64 else a for a in args16]
            kernel = getattr(kernels, op)
            plain_fn = getattr(g1_ops, op)
            t_plain = [time_ms(lambda: plain_fn(*args16), reps=3, warm=1)]
            t_kernel = [time_ms(lambda: kernel(*k_args), reps=200, warm=5)]
            t_kernel.append(time_ms(lambda: kernel(*k_args), reps=200, warm=5))
            t_plain.append(time_ms(lambda: plain_fn(*args16), reps=3, warm=1))
            nbytes = M * FP_BYTES * {"madd": 3 + 2 + 3, "add": 3 + 3 + 3, "dbl": 3 + 3}[op]
            nbytes += M if op == "madd" else 0
            # random lanes are all live and finite, and none doubles
            imads = FP_MULS[op] * M * IMAD_PER_FP_MUL
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
            entry = {
                "name": kernel.name,
                "route": "cuda",
                "source": f"{PKG}/csrc/g1.cu",
                "replaces": kernel.replaces,
                "launches": launches[kernel.name],
                "max_abs_err": max_err[op],
                "ms": sum(t_kernel) / 2,
                "plain_ms": sum(t_plain) / 2,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "lanes": M,
            }
            entries.append(entry)
            log(f"  {kernel.name} M={M}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.2f} ms, "
                f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")

    log(json.dumps({"end_to_end": results, "card": card}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ must sit beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        run()
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
