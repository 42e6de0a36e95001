"""The port's generic MSM, JAX's windowed one (`ops/msm.py` `msm_device`,
`msm_batch_device`, `window_sums`; `ops/g1_ops.combine_windows`, the plain
version of the kernel g1_window_combine), on the CPU.

- the window digits equal JAX's `window_digits(...)[:num_windows(c,
  scalar_bits)]` (before its top-window alias split), and the port's
  window count JAX's `num_windows`;
- the window sums of a batch equal, window by window in affine form, the
  Python-int oracle S_w = sum_i d_{w,i} P_i;
- `g1_ops.combine_windows` equals JAX's `combine_windows_host` on the
  same window sums, with windows at infinity, Z != 1, and a window equal
  to (the doubling branch) and opposite to (infinity) the doubled
  accumulator; the kernel's wrapper refuses what it does not take;
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

The plain combine is a chain of c (W - 1) doublings, ~3 s at 255 bits on
one thread here at any lane count, so each case batches its MSMs into one
call; the mesh steps run at 32-bit scalars (8 windows at c = 4), the
shards' logic being the same at any width."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import R
from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import msm as JM
from lambdaworks_kzg_tpu_torch.constants import num_windows
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP
from lambdaworks_kzg_tpu_torch.parallel import batch_msm, make_mesh, sharded_msm

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


def _crafted_sums(pts, valid, c, windows, seed):
    """Window sums [3, 24, 3 W] of three MSMs, Z != 1 on every other
    lane: MSM 0 random with its window W - 3 at infinity; MSM 1's window
    W - 2 equal to 2^c S_{W-1} (the add doubles); MSM 2's opposite to it
    (the add gives infinity), the rest of the chain on from there."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(valid.numpy())
    lanes = 3 * windows
    jac = g1_ops.lift(pts[..., torch.from_numpy(rng.choice(live, lanes))], torch.ones(lanes, dtype=torch.bool))
    jac = torch.where((torch.arange(lanes) % 2 == 0)[None, None], g1_ops.dbl(jac), jac)
    jac[..., windows - 3] = 0
    for b, negate in ((1, False), (2, True)):
        top = jac[..., b * windows + windows - 1 : b * windows + windows]
        for _ in range(c):
            top = g1_ops.dbl(top)
        if negate:
            top = torch.stack([top[0], FP.neg(top[1]), top[2]])
        jac[..., b * windows + windows - 2] = top[..., 0]
    return jac


@pytest.mark.parametrize("c,windows", [(4, 5), (3, 4)])
def test_combine_windows_matches_jax_host(points, c, windows):
    _, pts, valid = points
    sums = _crafted_sums(pts, valid, c, windows, seed=c)
    got = g1_ops.combine_windows(sums, c, windows)
    assert tuple(got.shape) == (3, 24, 3)
    assert torch.equal(dispatch.combine_windows(sums, c, windows), got)  # the CPU route
    arr = sums.numpy().astype(np.uint32)
    for b, pt in enumerate(g1_ops.points_to_host(got)):
        want = JM.combine_windows_host(arr[..., b * windows : (b + 1) * windows], c)
        assert _affine(pt) == _affine(want), b


def test_window_combine_kernel_refuses_what_it_does_not_take(points):
    _, pts, valid = points
    sums = lb.to_u32_layout(_crafted_sums(pts, valid, 3, 4, seed=5))
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
