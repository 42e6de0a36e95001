"""The port's `utils/profiling.py` on the CPU at 64 lanes: `time_pipelined`
and `time_chained` time plain calls, `KernelStat`'s rates follow from its
fields, `roofline_table` has the JAX package's header and a row per stat
against the H100's speed of light, and the peak-rate constants are the
ones `chip_smoke.py` imports. No number here is a card's."""

import importlib.util
import os

import pytest
import torch

from lambdaworks_kzg_tpu.utils import profiling as JP
from lambdaworks_kzg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_timers_on_the_cpu():
    calls = []
    seconds = P.time_pipelined(lambda: calls.append(1), iters=5, device="cpu")
    assert len(calls) == 6 and seconds >= 0
    x0 = torch.zeros(3, dtype=torch.int64)
    seen = []
    per = P.time_chained(lambda v: seen.append(v) or v + 1, x0, iters=4)
    assert per >= 0 and [int(v[0]) for v in seen] == [0, 0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.collect_kernel_stats(64, device="cuda")


def test_kernel_stat_and_roofline_table():
    stat = P.KernelStat("g1_add (Jacobian+Jacobian)", 64, 64e-9 * 1000, P.fp_muls("add"))
    assert stat.ns_per_lane == pytest.approx(1000.0)
    assert stat.fp_mul_rate == pytest.approx(64 * P.fp_muls("add") / stat.seconds)
    table = P.roofline_table([stat]).splitlines()
    jax_header = JP.roofline_table([]).splitlines()
    assert table[:2] == jax_header and len(table) == 3
    pct = 100 * P.SOL_FP_MUL_NS * P.fp_muls("add") / 1000.0
    assert table[2].startswith("| g1_add (Jacobian+Jacobian) | 64 | 1000.000 |")
    assert table[2].endswith(f"| {pct:.3g}% |")
    assert P.fp_muls("madd") == 7 + 4 * P.IMAD_PER_FP_SQR / P.IMAD_PER_FP_MUL


def test_collect_kernel_stats_on_the_cpu():
    stats = P.collect_kernel_stats(lanes=64, device="cpu", iters=1)
    assert [s.name for s in stats] == ["g1_madd (Jacobian+affine)", "g1_add (Jacobian+Jacobian)",
                                       "g1_dbl", "fp_mul (plain PyTorch)"]
    assert all(s.lanes == 64 and s.seconds > 0 for s in stats)
    assert [s.field_muls_per_lane for s in stats] == [P.fp_muls("madd"), P.fp_muls("add"),
                                                      P.fp_muls("dbl"), 1.0]
    assert len(P.roofline_table(stats).splitlines()) == 6
    with pytest.raises(ValueError, match="multiple of 64"):
        P.collect_kernel_stats(lanes=100, device="cpu")


def test_chip_smoke_takes_the_constants_from_profiling():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("HBM_BYTES_PER_S", "IMAD_PER_S", "IMAD_PER_FP_MUL", "IMAD_PER_FP_SQR", "FP_OPS",
                 "card_line"):
        assert getattr(smoke, name) is getattr(P, name), name
    assert P.HBM_BYTES_PER_S == 3.35e12 and P.IMAD_PER_S == 16.75e12
    assert (P.IMAD_PER_FP_MUL, P.IMAD_PER_FP_SQR) == (588, 456)
    assert smoke.op_imads("add") == 11 * 588 + 5 * 456
