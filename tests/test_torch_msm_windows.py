"""The port's generic MSM, JAX's windowed one (`ops/msm.py` `msm_device`,
`msm_batch_device`, `window_sums`; `ops/g1_ops.combine_windows`, the plain
version of the kernel g1_window_combine), on the CPU.

- the window digits equal JAX's `window_digits(...)[:num_windows(c,
  scalar_bits)]` (before its top-window alias split), and the port's
  window count JAX's `num_windows`;
- the window sums of a batch equal, window by window in affine form, the
  Python-int oracle S_w = sum_i d_{w,i} P_i;
- `g1_ops.combine_windows`, on the kernel's schedule (runs of windows,
  their doublings side by side, a left comb of the runs' sums), equals
  JAX's Horner `combine_windows_host` in affine form at c = 4, 8 and 12
  (255 bits) and at small shapes of one to four runs, on
  `utils.combine_cases.combine_edge_sums` (Z != 1); a Python-int
  rendering of the schedule shows that those sums put an operand at
  infinity, equal and opposite operands into its Horner, comb and last
  adds; the kernel's rule of runs (csrc/msm.cu `combine_runs`, built here
  by the host's C++ compiler) equals `g1_ops.combine_runs`; the kernel's
  wrapper refuses what it does not take;
- `msm_device` and `msm_batch_device` equal the JAX host oracle `g1_msm`
  in affine form at c = 4 and 8, with 255- and 248-bit scalars, over
  points with an invalid one and equal (tiled) ones, and MSMs of random
  scalars, all-zero scalars, scalars whose top window crowds into one
  bucket, and r - 1; a scalar at or above 2^scalar_bits raises;
  `msm_device` equals its lane of the batch;
- the generic mesh steps (`parallel.msm.sharded_msm` by points and by
  windows, `batch_msm`) on logical CPU meshes (1, 1), (2, 2) and (1, 4)
  equal the unsharded call, itself equal to the host oracle, with one
  combine a call and, by points, one fold a row; across two ranks (the
  gather stood in for), each rank's window sums gathered and folded
  before the combine;
- `slow`: the generic MSM equals JAX's jitted `msm_device` +
  `combine_windows_host` (an XLA compile at this shape).

The plain combine is a chain of c (W - 1) doublings, ~5 s at 255 bits on
one thread here at any lane count, so each case batches its MSMs into one
call; the mesh steps run at 32-bit scalars (8 windows at c = 4), the
shards' logic being the same at any width."""

import os
import random
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import R
from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import msm as JM
from lambdaworks_kzg_tpu_torch.constants import num_windows
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.models import srs as port_srs
from lambdaworks_kzg_tpu_torch.models.kzg import KZG
from lambdaworks_kzg_tpu_torch.ops import backend as backend_mod
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend, auto_window
from lambdaworks_kzg_tpu_torch.parallel import batch_msm, make_mesh, sharded_msm
from lambdaworks_kzg_tpu_torch.utils import combine_cases

from .torch_common import host_table, opening

N_BASIS = 8
CHUNK = 3  # members a chunk lane takes at most: buckets of several chunks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def points():
    """16 points: 8 of the dev setup's Lagrange basis, one at infinity,
    tiled twice (equal points share buckets) -> (affine list, [2, 24, 16]
    limbs, valid)."""
    basis = list(srs.create_dev_setup(32, secret=0xFB).g1_lagrange_brp[:N_BASIS])
    basis[2] = None
    affine = basis * 2
    pts, valid = g1_ops.make_points_host(affine)
    return affine, lb.as_limb_tensor(pts), torch.from_numpy(valid)


def _scalar_cases(n, bits, c, seed):
    """[random, all zero, the top window crowded into one bucket, r - 1 and
    small ones] scalars below 2^bits, as lists of ints."""
    rng = random.Random(seed)
    top = min(R, 1 << bits)
    w = num_windows(c, bits)
    base = rng.randrange(1, top >> (c * (w - 1))) << (c * (w - 1))  # below top with any low bits
    crowded = [(base | rng.randrange(1 << (c * (w - 1)))) % top for _ in range(n)]
    edge = [top - 1, 1, 2, 0] * (n // 4)
    return [[rng.randrange(top) for _ in range(n)], [0] * n, crowded, edge]


def _oracle(scalars, affine):
    return JHC.to_affine(JHC.FP_OPS, JHC.g1_msm(scalars, affine))


def _affine(pt):
    return JHC.to_affine(JHC.FP_OPS, pt)


@pytest.mark.parametrize("bits", [255, 248])
@pytest.mark.parametrize("c", [4, 8, 12])
def test_window_digits_match_jax(c, bits):
    rng = np.random.default_rng(c + bits)
    scalars = [int.from_bytes(rng.bytes(32), "little") % min(R, 1 << bits) for _ in range(16)]
    got = msm.window_digits(msm.scalars_to_tensor(scalars), c, bits)
    want = JM.window_digits(JM.scalars_to_device(scalars), c)[: JM.num_windows(c, bits)]
    assert num_windows(c, bits) == JM.num_windows(c, bits) == got.shape[0]
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_window_sums_match_per_window_oracle(points):
    """Two MSMs at c = 4, 255 bits: each of their 2 x 64 window sums
    equals the Python-int MSM of that window's digits."""
    affine, pts, valid = points
    c, bits = 4, 255
    cases = _scalar_cases(len(affine), bits, c, seed=1)
    batch = torch.stack([msm.scalars_to_tensor(s) for s in (cases[0], cases[2])])
    digits = msm.window_digits(batch, c, bits)
    sums = msm.window_sums(pts, valid, digits, c, CHUNK, ops=g1_ops)
    w = num_windows(c, bits)
    assert tuple(sums.shape) == (3, 24, 2 * w)
    got = g1_ops.points_to_host(sums)
    for b in range(2):
        for k in range(w):
            d = digits[b, k].tolist()
            want = _oracle(d, affine) if any(d) else None
            assert _affine(got[b * w + k]) == want, (b, k)


@pytest.mark.parametrize("c,windows", [(4, 64), (8, 32), (12, 22), (3, 7), (8, 3), (3, 3), (4, 1)])
def test_combine_windows_matches_jax_host(c, windows):
    """The plain combine on its schedule of runs (255 bits at c = 4, 8,
    12, and small shapes: four runs, two, three of a window each, one
    window) equals JAX's Horner `combine_windows_host` in affine form on
    the three MSMs of `combine_edge_sums`, through the CPU route."""
    sums = combine_cases.combine_edge_sums(c, windows, seed=c + windows)
    got = dispatch.combine_windows(sums, c, windows)
    assert tuple(got.shape) == (3, 24, 3)
    arr = sums.numpy().astype(np.uint32)
    for b, pt in enumerate(g1_ops.points_to_host(got)):
        want = JM.combine_windows_host(arr[..., b * windows : (b + 1) * windows], c)
        assert _affine(pt) == _affine(want), b


def _schedule_events(s, c, windows):
    """The combine's schedule on one MSM's window scalars s_w (S_w = [s_w]
    G), mod r: its runs' Horner chains, D_j, then the left comb -> (set of
    (where, kind) of its adds, where "horner", "comb" or "last", kind
    "inf" for an operand at infinity, "equal" or "opposite" operands; the
    sum as a scalar)."""
    events = set()

    def add(a, b, where):
        if a == 0 or b == 0:
            events.add((where, "inf"))
        elif a == b:
            events.add((where, "equal"))
        elif (a + b) % R == 0:
            events.add((where, "opposite"))
        return (a + b) % R

    starts = g1_ops.combine_runs(windows, c)
    runs = len(starts)
    d = []
    for j in range(runs):
        lo, top = starts[j], (starts + [windows])[j + 1] - 1
        acc = s[top]
        for w in range(top - 1, lo - 1, -1):
            acc = add(acc * pow(2, c, R) % R, s[w], "horner")
        d.append(acc * pow(2, c * lo, R) % R)
    acc = d[0]
    for j in range(1, runs):
        acc = add(acc, d[j], "last" if j == runs - 1 else "comb")
    return events, acc


@pytest.mark.parametrize("c", [4, 8, 12])
def test_combine_edge_scalars_reach_every_exceptional_add(c):
    """At 255 bits, `combine_edge_scalars`' three
    MSMs put an operand at infinity, equal operands and opposite operands
    into a Horner add, a comb add and the last add, and a whole run at
    infinity (MSM 0's run G - 2); the schedule's sum is sum_w 2^(c w)
    s_w. The runs lengthen downwards and the top run holds one or two
    windows (`combine_runs`)."""
    windows = num_windows(c, 255)
    starts = g1_ops.combine_runs(windows, c)
    assert starts[0] == 0 and 3 <= len(starts) <= g1_ops.COMBINE_UNITS and windows - starts[-1] <= 2
    lengths = [b - a for a, b in zip(starts, starts[1:] + [windows])]
    assert lengths == sorted(lengths, reverse=True)
    scalars = combine_cases.combine_edge_scalars(c, windows, seed=c)
    events = []
    for s in scalars:
        ev, total = _schedule_events(s, c, windows)
        assert total == sum(k << (c * w) for w, k in enumerate(s)) % R
        events.append(ev)
    assert {("horner", "inf"), ("comb", "inf"), ("last", "opposite")} <= events[0]
    assert {("horner", "opposite"), ("comb", "equal"), ("last", "equal")} <= events[1]
    assert {("horner", "equal"), ("comb", "opposite"), ("last", "inf")} <= events[2]
    assert not any(scalars[0][starts[-2] : starts[-1]])


def test_kernel_combine_runs_equals_plain_rule(tmp_path):
    """The launcher's rule of runs (csrc/msm.cu `combine_runs` on its
    kCombineUnits), built alone by the host's C++ compiler (`$CXX`, as the
    native tier), gives the run starts `g1_ops.combine_runs` gives for
    every c in 1..12 and W in 1..260."""
    src = open(os.path.join(kernels.CSRC, "msm.cu")).read()
    units = re.search(r"^constexpr int kCombineUnits = (\d+);", src, re.M)
    rule = re.search(r"^inline int combine_runs\(.*?^}\n", src, re.S | re.M)
    assert units and rule and int(units[1]) == g1_ops.COMBINE_UNITS
    prog = tmp_path / "runs.cpp"
    prog.write_text(
        f"#include <cstdio>\nconstexpr int kCombineUnits = {units[1]};\n{rule[0]}"
        "int main() {\n  int lo[kCombineUnits + 1];\n  for (int c = 1; c <= 12; ++c)\n"
        "    for (int W = 1; W <= 260; ++W) {\n      const int g = combine_runs(W, c, lo);\n"
        "      std::printf(\"%d %d\", c, W);\n      for (int i = 0; i < g; ++i) std::printf(\" %d\", lo[i]);\n"
        "      std::printf(\"\\n\");\n    }\n}\n")
    exe = tmp_path / "runs"
    subprocess.run([os.environ.get("CXX") or "g++", "-std=c++17", "-O1", str(prog), "-o", str(exe)], check=True)
    got = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.splitlines()
    want = [" ".join(map(str, [c, w] + g1_ops.combine_runs(w, c))) for c in range(1, 13) for w in range(1, 261)]
    assert got == want


def test_window_combine_kernel_refuses_what_it_does_not_take():
    sums = lb.to_u32_layout(combine_cases.combine_edge_sums(3, 4, seed=5))
    kernels.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.window_combine(sums, 3, 4)
    with pytest.raises(ValueError, match="do not split"):
        kernels.window_combine(sums, 3, 5)
    with pytest.raises(ValueError, match="window bits"):
        kernels.window_combine(sums, 13, 4)
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)


@pytest.mark.parametrize("c,bits", [(4, 255), (4, 248), (8, 255), (8, 248)])
def test_msm_batch_device_matches_host_oracle(points, c, bits):
    affine, pts, valid = points
    cases = _scalar_cases(len(affine), bits, c, seed=c * bits)
    batch = torch.stack([msm.scalars_to_tensor(s) for s in cases])
    got = msm.msm_batch_device(pts, valid, batch, c, bits, CHUNK, ops=g1_ops)
    assert tuple(got.shape) == (3, 24, len(cases))
    for pt, s in zip(g1_ops.points_to_host(got), cases):
        assert _affine(pt) == _oracle(s, affine)
    with pytest.raises(ValueError, match=f"2\\^{bits - 8}"):
        msm.msm_batch_device(pts, valid, batch, c, bits - 8)


@pytest.fixture(scope="module")
def unsharded(points):
    """The mesh tests' scalars (32 bits, c = 4: 8 windows) and the
    unsharded generic MSM of a batch of three, each equal to the host
    oracle; msm_device of one equals the batch's lane."""
    affine, pts, valid = points
    c, bits = 4, 32
    rng = random.Random(5)
    ints = [[rng.randrange(1 << bits) for _ in affine] for _ in range(3)]
    batch = torch.stack([msm.scalars_to_tensor(s) for s in ints])
    got = msm.msm_batch_device(pts, valid, batch, c, bits, ops=g1_ops)
    want = [_affine(p) for p in g1_ops.points_to_host(got)]
    assert want == [_oracle(s, affine) for s in ints]
    assert torch.equal(msm.msm_device(pts, valid, batch[2], c, bits, ops=g1_ops), got[..., 2:3])
    return c, bits, batch, want


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)])
def test_mesh_generic_steps_equal_the_unsharded_call(points, unsharded, monkeypatch, shape):
    """sharded_msm by points and by windows (2 windows a device on
    (1, 4)) and batch_msm of 3 MSMs (padded to 4 on two rows) equal the
    unsharded generic MSM in affine form; each call makes one combine,
    and by points one fold call a row of its P window-sum arrays."""
    _, pts, valid = points
    c, bits, batch, want = unsharded
    mesh = make_mesh(["cpu"] * 4, data=shape[0], points=shape[1])
    combines, folds = [], []
    combine, fold = dispatch.combine_windows, dispatch.fold
    monkeypatch.setattr(dispatch, "combine_windows",
                        lambda s, c_, w: combines.append(w) or combine(s, c_, w))
    monkeypatch.setattr(dispatch, "fold", lambda p: folds.append(p.shape[0]) or fold(p))
    for shard in ("points", "windows"):
        combines.clear()
        folds.clear()
        got = sharded_msm(mesh, pts, valid, batch[1], c, shard, scalar_bits=bits)
        assert _affine(got) == want[1], shard
        assert combines == [num_windows(c, bits)]
        assert folds == ([shape[1]] if shard == "points" else [1])
    combines.clear()
    folds.clear()
    got = batch_msm(mesh, pts, valid, batch, c, scalar_bits=bits)
    assert [_affine(p) for p in got] == want
    assert combines == [num_windows(c, bits)] and folds == [shape[1]] * shape[0]


@pytest.mark.parametrize("shard", ["points", "windows"])
def test_generic_step_across_ranks_gathers_the_window_sums(points, unsharded, monkeypatch, shard):
    """A (1, 2) mesh across two processes, each owning one cell, in this
    one process: rank 1's window sums are made first (the gather stood in
    for by its own), infinity at rank 0's points or windows; rank 0's
    call gathers [rank 0, rank 1] and folds them before its one combine,
    and equals the unsharded call."""
    from lambdaworks_kzg_tpu_torch.parallel import distributed
    from lambdaworks_kzg_tpu_torch.parallel.mesh import Mesh

    _, pts, valid = points
    c, bits, batch, want = unsharded
    cpu = torch.device("cpu")

    def run(rank):
        mesh = Mesh(((cpu, cpu),), ranks=((0, 1),), rank=rank)
        return sharded_msm(mesh, pts, valid, batch[2], c, shard, scalar_bits=bits)

    partner = []
    monkeypatch.setattr(distributed, "all_gather_points", lambda out: partner.append(out) or out[None])
    run(1)
    monkeypatch.setattr(distributed, "all_gather_points", lambda out: torch.stack([out, partner[0]]))
    assert _affine(run(0)) == want[2]


SECRET = 0x5EC2E7  # the 4-point dev setup of the batch verification tests


def _dev_backend(n, mesh=None):
    """A CPU backend of the n-point dev setup under SECRET, its table from
    the host curve."""
    setup = port_srs.create_dev_setup(n, secret=SECRET)
    lagrange = g1_ops.lift(lb.as_limb_tensor(setup.lagrange_points), torch.from_numpy(setup.lagrange_valid))
    table = host_table([HC.to_affine(p) for p in g1_ops.points_to_host(lagrange)], auto_window(n))
    return TorchBackend(setup, "cpu", fixedbase=table, mesh=mesh)


def _three_call_verdict(kzg, commitments, zs, ys, proofs, r_powers):
    """The batch check as three MSMs (the JAX package's route: `msm` of
    r^i and of r^i z_i over the proofs, and of r^i and -sum r^i y_i over
    the commitments and G1), here the host oracle's, and the same pairing
    check."""
    proof_aff = [HC.to_affine(p) for p in proofs]
    lhs = HC.g1_msm(r_powers, proof_aff)
    proof_z = HC.g1_msm([r * z % R for r, z in zip(r_powers, zs)], proof_aff)
    neg_y = (-sum(r * y for r, y in zip(r_powers, ys))) % R
    c_minus_y = HC.g1_msm(r_powers + [neg_y], [HC.to_affine(c) for c in commitments]
                          + [HC.to_affine(HC.G1_GENERATOR)])
    return kzg._pairings_verify(HC.point_add(c_minus_y, proof_z), kzg.g2_one, lhs, kzg.g2_s)


def test_verify_batch_makes_one_msm_batch_call(monkeypatch):
    """KZG.verify_batch on a CPU backend with the native tier off (the
    plain generic MSM: one sort, accumulation, reduce and combine) makes
    one `msm_batch` call over [proofs, commitments, G1], at the window of
    its widest row (n + 1 points), and gives the three-call route's
    verdicts on a valid batch and on two corrupted ones; msm_batch's
    empty and mismatched calls."""
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    n = 4
    backend = _dev_backend(n)
    kzg = KZG(backend.setup, backend)
    calls, windows = [], []
    batch, combine = backend.msm_batch, dispatch.combine_windows
    monkeypatch.setattr(backend, "msm_batch", lambda rows, pts: calls.append(len(pts)) or batch(rows, pts))
    monkeypatch.setattr(dispatch, "combine_windows",
                        lambda s, c, w: windows.append((c, w)) or combine(s, c, w))
    rng = random.Random(7)
    cs, zs, ys, ps = map(list, zip(*(opening(rng, n, SECRET) for _ in range(3))))
    r = rng.randrange(1, R)
    r_powers = [pow(r, i, R) for i in range(3)]
    cases = [(cs, zs, ys, ps), (cs, zs, ys, [ps[1], ps[0], ps[2]]),
             (cs, zs, [(ys[0] + 1) % R] + ys[1:], ps)]
    verdicts = []
    for args in cases:
        calls.clear()
        windows.clear()
        verdicts.append(kzg.verify_batch(*args, r_powers))
        assert calls == [2 * 3 + 1] and windows == [(auto_window(3 + 1), num_windows(4, 255))]
        assert verdicts[-1] is _three_call_verdict(kzg, *args, r_powers)
    assert verdicts == [True, False, False]
    assert backend.msm_batch([], [None]) == []
    assert all(HC.is_infinity(p) for p in backend.msm_batch([[], []], []))
    with pytest.raises(ValueError, match="counts"):
        backend.msm_batch([[1, 2]], [None])


@pytest.mark.parametrize("route", ["device", "mesh", "native"])
def test_backend_msm_batch_routes(points, monkeypatch, route):
    """TorchBackend.msm_batch of three rows (32-bit scalars, zeros among
    them) over 17 points equals the host oracle row by row on each route:
    the CPU device with the native tier off (one msm_batch_device call: one
    combine), a (1, 2) CPU mesh above its threshold (one batch_msm call,
    one combine), and the native tier (no combine)."""
    affine, _, _ = points
    n = 4
    mesh = make_mesh(["cpu"] * 2, data=1, points=2) if route == "mesh" else None
    backend = _dev_backend(n, mesh)
    if route != "native":
        monkeypatch.setenv("LWKZG_NATIVE", "0")
    combines, batches = [], []
    combine, batch = dispatch.combine_windows, backend_mod.pmsm.batch_msm
    monkeypatch.setattr(dispatch, "combine_windows", lambda s, c, w: combines.append(w) or combine(s, c, w))
    monkeypatch.setattr(backend_mod.pmsm, "batch_msm", lambda *a: batches.append(1) or batch(*a))
    pts = affine + [_affine(JHC.G1_GENERATOR)]
    rng = random.Random(17)
    rows = [[rng.randrange(1 << 32) for _ in pts] for _ in range(3)]
    rows[1][:8] = [0] * 8
    got = backend.msm_batch(rows, pts, scalar_bits=32)
    assert [HC.to_affine(p) for p in got] == [_oracle(row, pts) for row in rows]
    assert combines == ([] if route == "native" else [num_windows(4, 32)])
    assert batches == ([1] if route == "mesh" else [])


@pytest.mark.slow  # an XLA-on-CPU compile of JAX's generic MSM at this shape
def test_generic_msm_matches_jax_msm_device(points):
    affine, pts, valid = points
    c, bits = 4, 248
    scalars = _scalar_cases(len(affine), bits, c, seed=11)[0]
    jpts, jvalid = pts.numpy().astype(np.uint32), valid.numpy()
    sums = JM.msm_device(jnp.asarray(jpts), jnp.asarray(jvalid), JM.scalars_to_device(scalars), c, bits)
    want = JM.combine_windows_host(sums, c)
    got = msm.msm(pts, valid, msm.scalars_to_tensor(scalars), c, bits, CHUNK)
    assert _affine(got) == _affine(want) == _oracle(scalars, affine)
