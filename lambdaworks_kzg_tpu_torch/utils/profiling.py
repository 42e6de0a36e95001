"""Kernel timing and a roofline table on the card (the JAX package's
`utils/profiling.py`), and the H100's peak rates that `chip_smoke.py`
computes its bounds from.

`time_pipelined` times calls queued back to back behind CUDA events;
`time_chained` times data-dependent applications of one step captured in
one CUDA graph and replayed, so host dispatch is left out (JAX's jitted
`fori_loop`). `roofline_table` sets each kernel's ns per lane against the
H100's speed of light for its Fp products; its header is JAX's, whose
last column names the speed of light of JAX's chip. On the CPU both
timers take `time.perf_counter` around plain calls, which says how fast
the plain versions are there and nothing of the card.

Print the table on the card, after the card's name and power limit:

    python -m lambdaworks_kzg_tpu_torch.utils.profiling
"""

import subprocess
import time
from dataclasses import dataclass
from typing import Callable, List

import torch

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
# The same for an Fr product (8 x 32-bit limbs, csrc/fr.cuh): 64 wide
# products for a b, 64 for the reduction, 8 low products for m; a
# squaring's 28 shared cross products and 8 squares make 36.
IMAD_PER_FR_MUL = 2 * (64 + 64) + 8
IMAD_PER_FR_SQR = 2 * (36 + 64) + 8
# A reduction alone (a R^-1, out of Montgomery form): the 64 wide products
# and 8 low ones of the reduction, without a b's.
IMAD_PER_FR_REDC = 2 * 64 + 8
# (products, squarings) of one point op on finite, non-doubling operands.
# A doubling is counted as dbl-2009-l with Z3 = 2 Y Z (2 products, 5
# squarings), the fewest IMADs for it; the kernels compute the same Z3 as
# (Y + Z)^2 - YY - ZZ (1 product, 7 squarings), which costs 324 more.
FP_OPS = {"madd": (7, 4), "add": (11, 5), "dbl": (2, 5)}
# the least time one lane's Fp product can take on the card
SOL_FP_MUL_NS = IMAD_PER_FP_MUL / IMAD_PER_S * 1e9


def fp_muls(op: str) -> float:
    """One point op's Fp products, a squaring counted at its IMADs."""
    products, squarings = FP_OPS[op]
    return products + squarings * IMAD_PER_FP_SQR / IMAD_PER_FP_MUL


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def time_pipelined(fn: Callable[[], object], iters: int = 10, device="cuda") -> float:
    """Seconds per call of `iters` calls queued back to back: CUDA events
    around them on a card, after one warm call; perf_counter on the CPU."""
    fn()  # warm: builds, caches constants
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def time_chained(step: Callable, x0: torch.Tensor, iters: int = 64) -> float:
    """Seconds per application of `step` in x_{i+1} = step(x_i): on a card
    the `iters` applications are captured in one CUDA graph and replayed
    (no host dispatch in the time; a step that cannot be captured
    raises); on the CPU, a plain loop."""
    step(x0)  # warm: builds, caches constants
    if not x0.is_cuda:
        t0 = time.perf_counter()
        x = x0
        for _ in range(iters):
            x = step(x)
        return (time.perf_counter() - t0) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(x0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = x0
        for _ in range(iters):
            x = step(x)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@dataclass
class KernelStat:
    name: str
    lanes: int
    seconds: float
    field_muls_per_lane: float  # Fp products each lane performs (squarings at their cost)

    @property
    def ns_per_lane(self) -> float:
        return self.seconds / self.lanes * 1e9

    @property
    def fp_mul_rate(self) -> float:
        """Fp products per second achieved."""
        return self.lanes * self.field_muls_per_lane / self.seconds


def roofline_table(stats: List[KernelStat]) -> str:
    """A markdown table: ns per lane, Fp products per second, and the
    share of the card's speed of light (SOL_FP_MUL_NS per product)."""
    lines = [
        "| kernel | lanes | ns/lane | Fp-mul/s | % of VPU speed-of-light |",
        "|---|---|---|---|---|",
    ]
    for s in stats:
        sol = SOL_FP_MUL_NS * s.field_muls_per_lane
        pct = 100.0 * sol / s.ns_per_lane if s.ns_per_lane else 0.0
        lines.append(f"| {s.name} | {s.lanes} | {s.ns_per_lane:.3f} | "
                     f"{s.fp_mul_rate:.2e} | {pct:.3g}% |")
    return "\n".join(lines)


def collect_kernel_stats(lanes: int = 8192, device="cuda", iters: int = 64) -> List[KernelStat]:
    """Time g1_madd, g1_add and g1_dbl, and the plain Fp product, at
    `lanes` lanes (a multiple of 64) of a dev setup's points, each by
    `time_chained`; on the CPU their plain versions."""
    from ..models import srs
    from ..ops import g1_ops, kernels, limbs as lb
    from ..ops.dispatch import resolve_device, to_op_layout
    from ..ops.field_ops import FP

    dev = resolve_device(device)
    if lanes < 64 or lanes % 64:
        raise ValueError(f"lanes must be a positive multiple of 64, got {lanes}")
    setup = srs.create_dev_setup(64, secret=0xBEEF)
    reps = lanes // 64
    aff16 = lb.as_limb_tensor(setup.lagrange_points, dev).repeat(1, 1, reps)
    valid = torch.from_numpy(setup.lagrange_valid.copy()).to(dev).repeat(reps)
    p16 = g1_ops.lift(aff16, valid)
    q16 = g1_ops.dbl(p16)
    ops = kernels if dev.type == "cuda" else g1_ops
    p, q, aff = to_op_layout(p16), to_op_layout(q16), to_op_layout(aff16)
    return [
        KernelStat("g1_madd (Jacobian+affine)", lanes,
                   time_chained(lambda v: ops.madd(v, aff, valid), p, iters), fp_muls("madd")),
        KernelStat("g1_add (Jacobian+Jacobian)", lanes,
                   time_chained(lambda v: ops.add(v, q), p, iters), fp_muls("add")),
        KernelStat("g1_dbl", lanes, time_chained(ops.dbl, p, iters), fp_muls("dbl")),
        KernelStat("fp_mul (plain PyTorch)", lanes,
                   time_chained(lambda v: FP.mul(v, q16[0]), p16[0], iters), 1.0),
    ]


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("profiling: CUDA is not available; the table is the card's")
    print(card_line())
    print(roofline_table(collect_kernel_stats()))
