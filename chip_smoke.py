#!/usr/bin/env python3
"""Smoke run of lambdaworks_kzg_tpu_torch on one NVIDIA card (built for H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. nvcc builds the six kernels and the field check from
     lambdaworks_kzg_tpu_torch/csrc (one nvcc per source, all at once,
     linked into one library);
  3. each kernel against its plain PyTorch version on the card, limb for
     limb: fp::sqr against fp::mul(a, a) and the plain square on random
     elements and on 0, 1, p - 1 and R mod p; g1_fixedbase_table against
     g1_ops.fixedbase_table at c = 4, 8 and 12 on 256 lanes of the mainnet
     basis with every 7th lane invalid, and at the mainnet shape (4096
     lanes, c = 8); g1_madd, g1_add and g1_dbl at lane counts 1 to 4096 (and 200,
     a partly filled second block) with random and exceptional lanes (P at
     infinity, P == Q, P == -Q, dead lanes); g1_bucket_accumulate and
     g1_bucket_reduce on the committed mainnet table at c = 8 for one and
     for six seeded blobs, on a synthetic table of four points and their
     negations repeated (so runs of members double, cancel to infinity
     and lift again, beside empty and dead buckets) at c = 4 and c = 12,
     and g1_bucket_reduce on synthetic buckets at c = 12, where its points
     live in global memory instead of shared memory;
  4. the mainnet setup (testdata/trusted_setup.txt and its committed
     conversion); EIP4844Context(setup, device="cuda") builds the
     fixed-base table with one g1_fixedbase_table launch and no g1_dbl
     launch, and the table must equal
     cache/fixedbase_62bcf72bba2b37b8_c8.npz bit for bit;
  5. the ten blob_to_kzg_commitment consensus vectors;
  6. three seeded random blobs through blob_to_kzg_commitment and a
     batch of six through blob_to_kzg_commitment_batch (twice), timed
     with CUDA events; one blob also through the plain PyTorch path on
     the card;
  7. each kernel timed with CUDA events: the MSM kernels at the path's
     shapes for one blob and for six (seeded random blobs, c = 8), madd at
     the 2048 lanes of one blob's bucket grid, add at 1024, dbl at 4096,
     on random lanes, and the table kernel at the mainnet shape.
Launch counts are zeroed just before phase 4 and read after phase 6, so
they count the main path only; phase 4 checks that the table build made
one table launch and no g1_dbl launch, phase 6 that one commit, and a
batch of six, launch each MSM kernel once. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}. Any failure
ends the run with a non-zero exit and without those lines.
"""

import json
import os
import random
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
# One Montgomery product (12 x 32-bit limbs): 144 wide 32x32->64 products
# (two IMADs each) for a b, 144 for the reduction and 12 low products for
# m; a squaring shares its 66 cross products, so a a takes 78 wide ones.
IMAD_PER_FP_MUL = 2 * (144 + 144) + 12
IMAD_PER_FP_SQR = 2 * (78 + 144) + 12
FP_BYTES = 48
# (products, squarings) of one point op on finite, non-doubling operands.
# A doubling is counted as dbl-2009-l with Z3 = 2 Y Z (2 products, 5
# squarings), the fewest IMADs for it; the kernels compute the same Z3 as
# (Y + Z)^2 - YY - ZZ (1 product, 7 squarings), which costs 324 more.
FP_OPS = {"madd": (7, 4), "add": (11, 5), "dbl": (2, 5)}


def op_imads(op: str) -> int:
    muls, sqrs = FP_OPS[op]
    return muls * IMAD_PER_FP_MUL + sqrs * IMAD_PER_FP_SQR


def chain_ops(e: int, k: int) -> tuple:
    """(products, squarings) of a left-to-right sliding-window power a^e
    with the odd powers a, a^3 .. a^(2^k - 1) precomputed."""
    muls, sqrs = (2 ** (k - 1) - 1, 1) if k > 1 else (0, 0)
    bits, i, first = bin(e)[2:], 0, True
    while i < len(bits):
        if bits[i] == "0":
            sqrs, i = sqrs + 1, i + 1
            continue
        j = min(i + k, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            muls, sqrs = muls + 1, sqrs + j - i
        first, i = False, j
    return muls, sqrs


def inv_imads() -> int:
    """IMADs of a^(p - 2) by the cheapest sliding window of 1 to 8 bits
    (5 bits: 82 products and 378 squarings). fp::inv runs the 1-bit
    chain, 228 products and 380 squarings."""
    from lambdaworks_kzg_tpu_torch.constants import P

    return min(m * IMAD_PER_FP_MUL + s * IMAD_PER_FP_SQR
               for m, s in (chain_ops(P - 2, k) for k in range(1, 9)))


def table_imads(n_valid: int, c: int) -> int:
    """IMADs g1_fixedbase_table needs for n_valid source lanes (an invalid
    lane needs none): (W - 1) c doublings, W - 1 prefix products, one
    inversion (`inv_imads`), and backward W - 1 products for each Z^-1
    and W - 1 to peel Z off, then per window x = X Z^-2, y = Y Z^-3 (3
    products and a squaring). On the setup's points no Z is 0, so nothing
    is skipped."""
    from lambdaworks_kzg_tpu_torch.constants import num_windows

    w = num_windows(c)
    muls = 3 * (w - 1) + 3 * w
    per_lane = (w - 1) * c * op_imads("dbl") + muls * IMAD_PER_FP_MUL + w * IMAD_PER_FP_SQR + inv_imads()
    return n_valid * per_lane

# Lane counts of phase 3 for the per-op kernels (and 200, a block and a
# partial one), each holding the exceptional lanes its lane pattern reaches
CHECK_LANES = (1, 2, 4, 8, 16, 32, 64, 128, 200, 256, 512, 1024, 2048, 4096)
C_MAIN, GROUPS = 8, 8  # the mainnet path's window bits and lane groups
PATH_KERNELS = ("g1_bucket_accumulate", "g1_bucket_reduce", "g1_fixedbase_table")


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


def random_blobs(rng, count: int):
    """Seeded blobs of canonical elements (31 random bytes, a zero top)."""
    return [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(count)]


def blob_members(table_valid, blobs, c: int):
    """Blobs -> (order, bstart) as the main path sorts them."""
    import numpy as np
    import torch

    from lambdaworks_kzg_tpu_torch.ops import codec, limbs as lb, msm

    scalars = lb.as_limb_tensor(
        np.stack([codec.blob_to_limbs(b, 4096) for b in blobs]), table_valid.device)
    digits = msm.fixedbase_digits(scalars, c)
    return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), c)


def synthetic_table(points, n_rows: int, c: int, n_blobs: int, seed: int):
    """A table whose rows repeat four setup points and their negations, and
    members sorted by seeded digits in which bucket 1 stays empty and
    bucket 0 (dead) is full -> (table [2, 24, n_rows], order, bstart)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import msm
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    pool = points[:, :, :4]
    pool = torch.cat([pool, torch.stack([pool[0], FP.neg(pool[1])])], dim=-1)
    table = pool[:, :, torch.arange(n_rows, device=points.device) % 8].contiguous()
    g = torch.Generator().manual_seed(seed)
    digits = torch.randint(0, 1 << c, (n_blobs, n_rows), generator=g)
    digits = torch.where(digits == 1, torch.zeros_like(digits), digits)
    perm = torch.stack([torch.randperm(n_rows, generator=g) for _ in range(n_blobs)])
    order, bstart = msm.sort_members(digits.to(points.device), c)
    order = torch.gather(perm.to(points.device).to(order.dtype), 1, order.long())
    return table, order, bstart


def synthetic_buckets(points, c: int, n_blobs: int, seed: int):
    """[3, 24, B G 2^c] Jacobian buckets: setup points, Z != 1 on every
    third lane, and in every group one bucket at infinity, one pair equal
    and one pair opposite across the first fold."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    m = n_blobs * GROUPS << c
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, points.shape[-1], (m,), generator=g).to(points.device)
    lane = torch.arange(m, device=points.device)
    bk = g1_ops.lift(points[:, :, pick], torch.ones(m, dtype=torch.bool, device=points.device))
    bk = torch.where((lane % 3 == 0)[None, None], g1_ops.dbl(bk), bk)
    h = 1 << (c - 1)
    base = torch.arange(0, m, 1 << c, device=points.device)
    bk[:, :, base + 2] = 0
    bk[:, :, base + 1 + h] = bk[:, :, base + 1]
    opp = bk[:, :, base + 3]
    bk[:, :, base + 3 + h] = torch.stack([opp[0], FP.neg(opp[1]), opp[2]])
    return bk.contiguous()


def same(name: str, got16, want16) -> int:
    """Raise unless kernel and plain agree limb for limb -> max |limb error|."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got16, want16):
        bad = int((got16 != want16).any(dim=0).any(dim=0).sum().item())
        raise AssertionError(f"{name}: kernel differs from plain on {bad} lanes")
    return int((got16 - want16).abs().max()) if got16.numel() else 0


def check_msm_kernels(label: str, table16, order, bstart, c: int, max_err: dict,
                      extra_buckets=None) -> None:
    """Both MSM kernels against their plain versions on the same inputs:
    the accumulation, then the reduce of its buckets (and of
    `extra_buckets`); max_err[name] keeps each kernel's max |limb error|."""
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb

    def check(name: str, what: str, got16, want16) -> None:
        max_err[name] = max(max_err[name], same(f"{name} {what}", got16, want16))
        log(f"  {name} {what}: equal to plain, limb for limb")

    rows = dispatch.to_table_layout(table16)
    plain = g1_ops.bucket_accumulate(table16, order, bstart, c, GROUPS)
    got = kernels.bucket_accumulate(rows, order, bstart, c, GROUPS)
    check("g1_bucket_accumulate", label, lb.to_u16_layout(got), plain)
    for what, buckets in (("its buckets", plain), ("synthetic buckets", extra_buckets)):
        if buckets is None:
            continue
        got = kernels.bucket_reduce(lb.to_u32_layout(buckets), c, GROUPS)
        check("g1_bucket_reduce", f"{label}, {what}", lb.to_u16_layout(got),
              g1_ops.bucket_reduce(buckets, c, GROUPS))


def accumulate_point_ops(order, bstart):
    """(madds, lifts) that g1_bucket_accumulate needs for these members:
    each member outside bucket 0 is one step of its group-bucket, and the
    first step of each non-empty group-bucket lifts the point (no
    products). A run of members never returns a bucket to infinity
    (P + -P) on random blobs, so no other step is free."""
    import torch

    n_members = order.shape[1]
    bend = torch.cat([bstart[:, 1:], torch.full_like(bstart[:, :1], n_members)], dim=1)
    counts = (bend - bstart)[:, 1:].long()
    live = int(counts.sum())
    lifts = int(counts.clamp(max=GROUPS).sum())
    return live - lifts, lifts


def reduce_point_ops(buckets16, c: int):
    """(adds, doublings) that g1_bucket_reduce needs on these buckets: the
    schedule of g1_ops.bucket_reduce (fold, tree of each high half,
    Horner chain, group tree) run on which points are at infinity. An add
    with an operand at infinity, and a doubling of infinity, need no
    products; a sum of finite points is counted finite (on random blobs
    none cancels)."""
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    nb = 1 << c
    finite = ~FP.is_zero(buckets16[2])
    finite = finite.reshape(-1, nb).clone()
    finite[:, 0] = False  # bucket 0 has weight 0
    counts = {"adds": 0, "dbls": 0}

    def add(a, b):
        counts["adds"] += int((a & b).sum())
        return a | b

    def tree(x):
        while x.shape[-1] > 1:
            half = x.shape[-1] // 2
            x = add(x[..., :half], x[..., half:])
        return x[..., 0]

    totals, arr, h = [], finite, nb // 2
    while h >= 1:
        totals.append(tree(arr[:, h : 2 * h]))
        arr = add(arr[:, :h], arr[:, h : 2 * h])
        h //= 2
    acc = totals[0]
    for e in totals[1:]:
        counts["dbls"] += int(acc.sum())
        acc = add(acc, e)
    tree(acc.reshape(-1, GROUPS))
    return counts["adds"], counts["dbls"]


def check_table(label: str, points16, valid, c: int):
    """g1_fixedbase_table against g1_ops.fixedbase_table on the same basis,
    limb for limb -> (max |limb error|, kernel ms, plain ms), one call of
    each timed with CUDA events."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import num_windows
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm

    points32 = lb.to_u32_layout(points16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    rows = kernels.fixedbase_table(points32, valid, c)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    start.record()
    want, want_valid = msm.build_fixedbase_tables(points16, valid, c, ops=g1_ops)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = same(f"g1_fixedbase_table {label}", dispatch.from_table_layout(rows), want)
    if not torch.equal(want_valid, valid.repeat(num_windows(c))):
        raise AssertionError(f"g1_fixedbase_table {label}: plain valid mask is not the basis' repeated")
    log(f"  g1_fixedbase_table {label}: equal to plain, limb for limb "
        f"(kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms)")
    return err, kernel_ms, plain_ms


def check_sqr(dev, count: int, seed: int) -> None:
    """fp::sqr against fp::mul(a, a) and the plain square FP.sqr, on 0, 1,
    p - 1, R mod p (Montgomery one) and seeded random elements."""
    from lambdaworks_kzg_tpu_torch.constants import P
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    rng = random.Random(seed)
    values = [0, 1, P - 1, (1 << 384) % P] + [rng.randrange(P) for _ in range(count - 4)]
    a = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs(values, 24), dev))
    sq, mm = kernels.sqr_check(a)
    same("fp::sqr against fp::mul(a, a)", sq, mm)
    same("fp::sqr against FP.sqr", lb.to_u16_layout(sq), FP.sqr(lb.to_u16_layout(a)))
    log(f"  fp::sqr M={count}: equal to fp::mul(a, a) and to the plain square")


def check_kernel(op: str, args16) -> int:
    """Kernel vs plain version on the same inputs, limb for limb -> max
    |limb error|."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb

    plain = getattr(g1_ops, op)(*args16)
    k_args = [lb.to_u32_layout(a) if a.dtype == torch.int64 else a for a in args16]
    return same(op, lb.to_u16_layout(getattr(kernels, op)(*k_args)), plain)


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Device ms per call. The launches queue up behind a ~20 ms spin on
    the card, so a kernel shorter than its wrapper's host cost is timed
    on the card's clock, not the host's."""
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


def run() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA card")

    from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError, convert, load_mainnet_setup
    from lambdaworks_kzg_tpu_torch.constants import num_windows
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import codec, dispatch, g1_ops, kernels, limbs as lb, msm
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
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log("  " + line.strip())

    setup = load_mainnet_setup()
    points = lb.as_limb_tensor(setup.lagrange_points, dev)
    points_valid = torch.from_numpy(setup.lagrange_valid.copy()).to(dev)
    max_err = {k.name: 0 for k in kernels.ALL}
    with Phase("3 kernels vs plain"):
        check_sqr(dev, 4096, seed=5)
        lane = torch.arange(256, device=dev)
        for c in (4, 8, 12):
            err, _, _ = check_table(f"c={c} N=256, every 7th lane invalid", points[:, :, :256],
                                    points_valid[:256] & (lane % 7 != 3), c)
            max_err["g1_fixedbase_table"] = max(max_err["g1_fixedbase_table"], err)
        err, table_kernel_ms, table_plain_ms = check_table(
            f"c={C_MAIN} N={points.shape[-1]} (mainnet)", points, points_valid, C_MAIN)
        max_err["g1_fixedbase_table"] = max(max_err["g1_fixedbase_table"], err)
        for M in CHECK_LANES:
            p, q, live, q3 = make_lanes(points, M, seed=M)
            for op, args in (("madd", (p, q, live)), ("add", (p, q3)), ("dbl", (p,))):
                name = getattr(kernels, op).name
                max_err[name] = max(max_err[name], check_kernel(op, args))
                log(f"  {op} M={M}: equal to plain, limb for limb")
        table16, table_valid = convert.fixedbase_from_npz(FIXEDBASE, dev)
        rng = np.random.default_rng(3)
        for n_blobs in (1, 6):
            order, bstart = blob_members(table_valid, random_blobs(rng, n_blobs), C_MAIN)
            check_msm_kernels(f"mainnet c={C_MAIN} B={n_blobs}", table16, order, bstart, C_MAIN,
                              max_err)
        for c, n_blobs in ((4, 2), (12, 1)):
            synth, order, bstart = synthetic_table(points, 4096, c, n_blobs, seed=c)
            check_msm_kernels(f"synthetic c={c} B={n_blobs}", synth, order, bstart, c, max_err,
                              extra_buckets=synthetic_buckets(points, c, n_blobs, seed=c))

    kernels.reset_counts()
    with Phase("4 setup and fixed-base table"):
        t0 = time.perf_counter()
        ctx = EIP4844Context(setup, device="cuda")
        torch.cuda.synchronize()
        results["table_build_s"] = time.perf_counter() - t0
        results["table_kernel_ms_phase3"] = table_kernel_ms
        built = {k.name: k.launches for k in kernels.ALL}
        if built["g1_fixedbase_table"] != 1 or built["g1_dbl"] != 0:
            raise AssertionError(f"one table build must launch g1_fixedbase_table once and g1_dbl "
                                 f"never ({built})")
        table, valid = ctx.backend.fixedbase()
        with np.load(FIXEDBASE) as ref:
            same_table = np.array_equal(table.cpu().numpy().astype(np.uint32), ref["table"])
            same_valid = np.array_equal(valid.cpu().numpy(), ref["valid"])
        if not (same_table and same_valid):
            raise AssertionError(f"fixed-base table differs (table {same_table}, valid {same_valid})")
        log(f"  table {tuple(table.shape)} built in {results['table_build_s']:.4f} s (the kernel "
            f"alone {table_kernel_ms:.3f} ms, phase 3, CUDA events), bit-equal to "
            f"{os.path.relpath(FIXEDBASE, HERE)}; one g1_fixedbase_table launch, no g1_dbl launch")

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
        blobs = random_blobs(rng, 6)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        msm_kernels = (kernels.bucket_accumulate, kernels.bucket_reduce)

        def timed(fn, *args):
            before = [k.launches for k in msm_kernels]
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            per_call = [k.launches - b for k, b in zip(msm_kernels, before)]
            if per_call != [1, 1]:
                raise AssertionError(f"one call launched (accumulate, reduce) {per_call}, not once each")
            return out, start.elapsed_time(end)

        runs = [timed(ctx.blob_to_kzg_commitment, b) for b in blobs[:3]]
        singles = [r[0] for r in runs]
        results["ms_per_blob_single"] = [r[1] for r in runs]
        runs = [timed(ctx.blob_to_kzg_commitment_batch, blobs) for _ in range(2)]
        batch = runs[0][0]
        results["ms_per_blob_batch6"] = [r[1] / len(blobs) for r in runs]
        launches = {k.name: k.launches for k in kernels.ALL}  # the main path ends here
        log(f"  single {results['ms_per_blob_single']} ms/blob, "
            f"batch of 6 {results['ms_per_blob_batch6']} ms/blob; launches {launches}; "
            "each commit and each batch launched each MSM kernel once")
        if singles != batch[:3] or runs[1][0] != batch or len(set(batch)) != len(batch):
            raise AssertionError("batch and single commitments disagree")
        scalars = lb.as_limb_tensor(codec.blob_to_limbs(blobs[1], 4096), dev)
        t0 = time.perf_counter()
        plain = HC.compress_g1(ctx.backend.commit_scalars(scalars, ops=g1_ops))
        log(f"  plain PyTorch path on the card: {time.perf_counter() - t0:.2f} s")
        if plain != batch[1]:
            raise AssertionError("kernel path and plain path commit differently")
        log("  blob 1: kernel path equals the plain path on the card")
        missing = [name for name in PATH_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"not launched on the main path: {missing} ({launches})")
        if launches["g1_fixedbase_table"] != 1 or launches["g1_dbl"] != 0:
            raise AssertionError(f"the main path must launch g1_fixedbase_table once and g1_dbl "
                                 f"never ({launches})")

    entries = []
    with Phase("7 kernel timing"):
        rows = dispatch.to_table_layout(table16)
        n_members, nb = rows.shape[0], 1 << C_MAIN
        msm_times = {}
        for n_blobs in (1, 6):
            order, bstart = blob_members(table_valid, random_blobs(rng, n_blobs), C_MAIN)
            acc_args = (rows, order, bstart, C_MAIN, GROUPS)
            buckets = kernels.bucket_accumulate(*acc_args)
            buckets16 = lb.to_u16_layout(buckets)
            t_acc = time_ms(lambda: kernels.bucket_accumulate(*acc_args), reps=10)
            t_red = time_ms(lambda: kernels.bucket_reduce(buckets, C_MAIN, GROUPS), reps=20)
            p_acc = time_ms(lambda: g1_ops.bucket_accumulate(table16, order, bstart, C_MAIN, GROUPS),
                            reps=1, warm=0)
            p_red = time_ms(lambda: g1_ops.bucket_reduce(buckets16, C_MAIN, GROUPS), reps=1, warm=0)
            # the accumulation reads the table, order and bstart once and
            # writes the buckets; the reduce reads them and writes B points
            madds, lifts = accumulate_point_ops(order, bstart)
            acc_bytes = n_members * 96 + order.numel() * 4 + bstart.numel() * 4
            acc_bytes += buckets.numel() * 4
            acc_imads = madds * op_imads("madd")
            adds, dbls = reduce_point_ops(buckets16, C_MAIN)
            red_bytes = buckets.numel() * 4 + n_blobs * 3 * FP_BYTES
            red_imads = adds * op_imads("add") + dbls * op_imads("dbl")
            log(f"  B={n_blobs}: accumulate {madds} madds + {lifts} lifts; "
                f"reduce {adds} adds + {dbls} doublings of finite points")
            for name, ms, plain_ms, nbytes, imads in (
                ("g1_bucket_accumulate", t_acc, p_acc, acc_bytes, acc_imads),
                ("g1_bucket_reduce", t_red, p_red, red_bytes, red_imads),
            ):
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
                msm_times[(name, n_blobs)] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                }
                log(f"  {name} B={n_blobs}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
                    f"bound {max(t_bytes, t_ops):.5f} ms")
        for kernel in (kernels.bucket_accumulate, kernels.bucket_reduce):
            entries.append({
                "name": kernel.name,
                "route": "cuda",
                "source": f"{PKG}/csrc/msm.cu",
                "replaces": kernel.replaces,
                "launches": launches[kernel.name],
                "max_abs_err": max_err[kernel.name],
                **msm_times[(kernel.name, 1)],
                "library_ms": None,
                "blobs": 1,
                "batch6": msm_times[(kernel.name, 6)],
            })
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
            imads = op_imads(op) * M
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
            entry = {
                "name": kernel.name,
                "route": "cuda",
                "source": f"{PKG}/csrc/g1.cu",
                "replaces": kernel.replaces,
                "launches": launches[kernel.name],
                "max_abs_err": max_err[kernel.name],
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
        # the table build at the mainnet shape; its plain time is phase 3's
        points32 = lb.to_u32_layout(points)
        n = points.shape[-1]
        t_table = [time_ms(lambda: kernels.fixedbase_table(points32, points_valid, C_MAIN), reps=5, warm=1)
                   for _ in range(2)]
        nbytes = n * (2 * FP_BYTES + 1) + num_windows(C_MAIN) * n * 2 * FP_BYTES
        n_valid = int(points_valid.sum())
        imads = table_imads(n_valid, C_MAIN)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
        entry = {
            "name": kernels.fixedbase_table.name,
            "route": "cuda",
            "source": f"{PKG}/csrc/table.cu",
            "replaces": kernels.fixedbase_table.replaces,
            "launches": launches[kernels.fixedbase_table.name],
            "max_abs_err": max_err[kernels.fixedbase_table.name],
            "ms": sum(t_table) / 2,
            "plain_ms": table_plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "lanes": n,
            "c": C_MAIN,
        }
        entries.append(entry)
        log(f"  g1_fixedbase_table N={n} c={C_MAIN} ({n_valid} valid lanes, {imads} IMADs): "
            f"kernel {t_table[0]:.4f} / {t_table[1]:.4f} ms, plain {table_plain_ms:.1f} ms, "
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
