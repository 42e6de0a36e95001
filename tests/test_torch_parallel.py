"""The port's multi-device tier against the JAX package, on the CPU.

Meshes here are logical: ["cpu"] * 8 named in (data, points) grids, so
every shard runs on the one CPU through the plain versions; this checks
the sharding, the padding and the folds, not any scaling.

- `make_mesh` chooses the axes as JAX `parallel/mesh.make_mesh` does on
  its 8 virtual CPU devices (tests/conftest.py), and raises where a mesh
  would need more devices than it is given, or CUDA that is absent;
- `sharded_msm` (JAX's windowed generic MSM, no table) on meshes (1, 1),
  (2, 4) and (1, 8), by points, windows and auto, equals the JAX host
  oracle `g1_msm` in affine form, with an invalid point and a zero
  scalar among the lanes, W = 85 windows (c = 3, 255-bit scalars) not
  divisible by 4 or 8, an all-zero vector giving infinity, and a
  scalar at or above 2^scalar_bits raising; `batch_msm` of 3 blobs on
  (2, 4) (padded to 4) equals it blob by blob, and so does the generic
  MSM of a backend on (2, 4) above its sharding threshold;
- the fold of the partials: a batch on (2, 4) makes one `dispatch.fold`
  call a row (one g1_fold launch each on a card), on (1, 1) only folds of
  one row (no launch), and an MSM across two processes (a mesh with
  ranks, the gather stood in for) one more fold of the gathered rows;
- `sharded_ntt_ints` forward and inverse equal JAX `host/fft.fr_fft` at
  n = 64 on 2, 4 and 8 devices of either axis, and round-trips; an n not
  divisible by D^2 raises;
- `KZGConfig.mesh_shape` / LWKZG_MESH_SHAPE reach the backend, and bad
  shapes and setups that do not divide over the points axis raise.

The slice as a whole runs in tests/test_torch_mesh_api.py.

The plain table build takes ~4 s at any size on one thread here, so the
module builds each basis's tables once, by the host oracle (Python
ints, as `tests/test_torch_prove.py` does), in place of
`dispatch.fixedbase_table`, for the backends' fixed-base shards; the
plain build itself is held against the kernel on the card
(tests/test_torch_cuda.py). The generic MSM builds no table: each call
pays the plain combine's chain, ~4-5 s at c = 3 on one thread. The `slow` tests hold the port's sharded MSM and NTT
against JAX's `parallel` on its (2, 4) CPU mesh (minutes of XLA
compile)."""

import random

import jax
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu.host import fft as JFFT
from lambdaworks_kzg_tpu.parallel import mesh as jmesh
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGConfig
from lambdaworks_kzg_tpu_torch.constants import R, num_windows
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.parallel import batch_msm, make_mesh, sharded_msm
from lambdaworks_kzg_tpu_torch.parallel import distributed
from lambdaworks_kzg_tpu_torch.parallel import msm as pmsm
from lambdaworks_kzg_tpu_torch.parallel.mesh import Mesh
from lambdaworks_kzg_tpu_torch.parallel.ntt import sharded_ntt_ints

from .test_torch_prove import N_DEV, dev_contexts
from .torch_common import host_table

SHAPES = [(1, 1), (2, 4), (1, 8)]
C_BITS = 3  # 85 windows at 255 bits: not divisible by 4 or 8, and the cheapest plain reduce


def cpu_mesh(data, points):
    return make_mesh(["cpu"] * 8, data=data, points=points)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _oracle_tables():
    """dispatch.fixedbase_table on the CPU, from the host oracle, once per
    (basis, c)."""
    built = {}

    def fixedbase_table(points16, valid, c):
        key = (points16.numpy().tobytes(), valid.numpy().tobytes(), c)
        if key not in built:
            jac = g1_ops.points_to_host(g1_ops.lift(points16, valid))
            built[key] = host_table([(x, y) if z else None for x, y, z in jac], c)
        return built[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "fixedbase_table", fixedbase_table)
        yield


@pytest.fixture(scope="module")
def dev_pair():
    return dev_contexts()


@pytest.fixture(scope="module")
def basis(dev_pair):
    """The dev setup's 32 Lagrange points with lane 3 made invalid:
    (points [2, 24, N], valid, the affine list the oracle takes)."""
    jax_ctx, _ = dev_pair
    affine = list(jax_ctx.setup.g1_lagrange_brp)
    affine[3] = None
    points, valid = g1_ops.make_points_host(affine)
    return lb.as_limb_tensor(points), torch.from_numpy(valid), affine


def _oracle(scalars, affine):
    return JHC.to_affine(JHC.FP_OPS, JHC.g1_msm(scalars, affine))


def _rand_blob(rng, n=N_DEV):
    return b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(n))


# -- the mesh -------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_make_mesh_axes_match_jax(k):
    axes = [{}, {"data": 1}, {"points": k}, {"data": 1, "points": k}]
    if k > 1:
        axes += [{"data": 2}, {"points": 2}, {"data": 2, "points": k // 2}, {"data": 1, "points": 1}]
    for kw in axes:
        want = jmesh.make_mesh(jax.devices()[:k], **kw)
        got = make_mesh(["cpu"] * k, **kw)
        assert got.shape == dict(zip(want.axis_names, want.devices.shape)), kw
        assert got.axis_names == want.axis_names
        assert got.lead == torch.device("cpu")


def test_make_mesh_raises_without_enough_devices():
    with pytest.raises(ValueError, match="2x2 mesh needs 4 devices"):
        make_mesh(["cpu"] * 2, data=2, points=2)
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, points=4)
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 4, data=0, points=4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda"])


# -- the sharded MSM -------------------------------------------------------------


@pytest.mark.parametrize("shard", ["points", "windows", "auto"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_msm_matches_host_oracle(basis, shape, shard):
    points, valid, affine = basis
    mesh = cpu_mesh(*shape)
    rng = random.Random(f"{shape} {shard}")
    scalars = [rng.randrange(R) for _ in range(N_DEV)]
    scalars[5] = 0
    got = sharded_msm(mesh, points, valid, msm.scalars_to_tensor(scalars), C_BITS, shard)
    assert HC.to_affine(got) == _oracle(scalars, affine)
    # N / P is far below 2^14: auto shards the windows, W = 85 not a multiple of P
    assert pmsm.resolve_shard(mesh, N_DEV, "auto") == "windows"
    assert shape[1] == 1 or num_windows(C_BITS, 255) % shape[1]


def test_sharded_msm_edge_cases(basis):
    points, valid, affine = basis
    mesh = cpu_mesh(2, 4)
    zeros = msm.scalars_to_tensor([0] * N_DEV)
    assert HC.is_infinity(sharded_msm(mesh, points, valid, zeros, C_BITS, "windows"))
    # only the invalid lane and one other hold a scalar: shards at infinity
    sparse = [0] * N_DEV
    sparse[3], sparse[30] = 7, R - 1
    got = sharded_msm(mesh, points, valid, msm.scalars_to_tensor(sparse), C_BITS, "points")
    assert HC.to_affine(got) == _oracle(sparse, affine)
    big = msm.scalars_to_tensor([1 << 250] + [1] * (N_DEV - 1))
    with pytest.raises(ValueError, match="not below 2\\^248"):
        sharded_msm(mesh, points, valid, big, C_BITS, "points", scalar_bits=248)
    with pytest.raises(ValueError, match="do not split"):
        sharded_msm(cpu_mesh(1, 3), points, valid, zeros, C_BITS, "points")
    with pytest.raises(ValueError, match="shard must be"):
        sharded_msm(mesh, points, valid, zeros, C_BITS, "rows")


def test_batch_msm_matches_host_oracle(basis):
    """Three blobs on two rows: padded with a zero blob to four."""
    points, valid, affine = basis
    rng = random.Random(31)
    batch = [[rng.randrange(R) for _ in range(N_DEV)] for _ in range(3)]
    got = batch_msm(cpu_mesh(2, 4), points, valid,
                    torch.stack([msm.scalars_to_tensor(s) for s in batch]), C_BITS)
    assert [HC.to_affine(p) for p in got] == [_oracle(s, affine) for s in batch]


def _counting_folds(monkeypatch) -> list:
    """dispatch.fold, recording the rows K of each call."""
    seen, fold = [], dispatch.fold

    def counting(points16):
        seen.append(points16.shape[0])
        return fold(points16)

    monkeypatch.setattr(dispatch, "fold", counting)
    return seen


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
def test_mesh_batch_folds_once_a_row(basis, monkeypatch, shape):
    """A batch of 3 blobs (padded to 4 on two rows) makes one fold call on
    each row of the data axis, of P partials: one g1_fold launch a row on
    a card where P > 1, none where P = 1 (a fold of one row)."""
    points, valid, affine = basis
    seen = _counting_folds(monkeypatch)
    rng = random.Random(47)
    batch = [[rng.randrange(R) for _ in range(N_DEV)] for _ in range(3)]
    got = batch_msm(cpu_mesh(*shape), points, valid,
                    torch.stack([msm.scalars_to_tensor(s) for s in batch]), C_BITS)
    assert seen == [shape[1]] * shape[0]
    assert [HC.to_affine(p) for p in got] == [_oracle(s, affine) for s in batch]


def test_msm_across_ranks_folds_the_gathered_rows_once(basis, monkeypatch):
    """A (1, 2) mesh across two processes, each owning one cell of the
    points axis, in this one process: rank 1's partial is made first with
    the gather stood in for by its own row; then rank 0's call folds its
    row of one (no launch) and the gathered [rank 0, rank 1] rows in one
    fold (one g1_fold launch on a card), equal to the host oracle."""
    points, valid, affine = basis
    cpu = torch.device("cpu")
    rng = random.Random(53)
    scalars = [rng.randrange(R) for _ in range(N_DEV)]
    tensor = msm.scalars_to_tensor(scalars)[None]

    def basis_of(rank):
        mesh = Mesh(((cpu, cpu),), ranks=((0, 1),), rank=rank)
        return pmsm.ShardedBasis(mesh, points, valid, C_BITS)

    monkeypatch.setattr(distributed, "all_gather_points", lambda out: out[None])
    partner = basis_of(1).msm(tensor)
    monkeypatch.setattr(distributed, "all_gather_points", lambda out: torch.stack([out, partner]))
    seen = _counting_folds(monkeypatch)
    got = basis_of(0).msm(tensor)
    assert seen == [1, 2]
    assert HC.to_affine(g1_ops.points_to_host(got)[0]) == _oracle(scalars, affine)


def test_backend_generic_msm_shards_and_pads(dev_pair, basis, monkeypatch):
    """Above max(16, 2 P) points the generic MSM pads with invalid lanes to
    P 2^k (20 -> 32 on P = 4) and shards; below it runs unsharded. The
    native tier is off: on a CPU backend it would take these sizes."""
    monkeypatch.setenv("LWKZG_NATIVE", "0")
    _, ctx = dev_pair
    _, _, affine = basis
    backend = TorchBackend(ctx.setup, "cpu", fixedbase=ctx.backend.fixedbase(),
                           mesh=cpu_mesh(2, 4))
    rng = random.Random(37)
    scalars = [rng.randrange(R) for _ in range(20)]
    assert HC.to_affine(backend.msm(scalars, affine[:20])) == _oracle(scalars, affine[:20])


# -- the sharded NTT -------------------------------------------------------------


@pytest.mark.parametrize("axis", ["data", "points"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_ntt_matches_host_fft(d, axis):
    mesh = cpu_mesh(d, 1) if axis == "data" else cpu_mesh(1, d)
    rng = random.Random(d)
    values = [rng.randrange(R) for _ in range(64)]
    fwd = sharded_ntt_ints(mesh, axis, values)
    assert fwd == JFFT.fr_fft(values)
    assert sharded_ntt_ints(mesh, axis, values, inverse=True) == JFFT.fr_fft(values, inverse=True)
    assert sharded_ntt_ints(mesh, axis, fwd, inverse=True) == values
    with pytest.raises(ValueError, match="divisible by D\\^2"):
        sharded_ntt_ints(mesh, axis, values[:d])


# -- the config -------------------------------------------------------------------


def test_config_mesh_shape_reaches_the_backend(monkeypatch, dev_pair):
    _, plain = dev_pair
    monkeypatch.setenv("LWKZG_MESH_SHAPE", "2x4")
    cfg = KZGConfig.from_env()
    assert cfg.mesh_shape == (2, 4)
    # the CPU is one device: a 2x4 mesh over it is asked for, and refused
    with pytest.raises(ValueError, match="2x4 mesh needs 8 devices, 1 given"):
        EIP4844Context(plain.setup, device="cpu", config=cfg)
    monkeypatch.setenv("LWKZG_MESH_SHAPE", "1X1")
    ctx = EIP4844Context(plain.setup, device="cpu")
    assert ctx.backend.mesh.shape == {"data": 1, "points": 1}
    assert ctx.backend.shards.tables[(torch.device("cpu"), 0)][0].shape == (2, 24, 64 * N_DEV)
    for bad in ("2by4", "2x", "x4", "2x4x1"):
        monkeypatch.setenv("LWKZG_MESH_SHAPE", bad)
        with pytest.raises(ValueError, match="LWKZG_MESH_SHAPE"):
            KZGConfig.from_env()
    for shape in ((0, 1), (2, 0)):
        with pytest.raises(ValueError, match="mesh_shape"):
            KZGConfig(mesh_shape=shape).validate()
    monkeypatch.delenv("LWKZG_MESH_SHAPE")
    assert KZGConfig.from_env().mesh_shape is None and KZGConfig().make_mesh() is None


def test_setup_must_divide_over_the_points_axis(dev_pair):
    _, plain = dev_pair
    with pytest.raises(ValueError, match="32 points do not split over a points axis of 3"):
        TorchBackend(plain.setup, "cpu", mesh=make_mesh(["cpu"] * 3, data=1, points=3))
    with pytest.raises(ValueError, match="not both"):
        EIP4844Context(plain.setup, backend=plain.backend, mesh=cpu_mesh(1, 1))
    with pytest.raises(ValueError, match="one table per shard"):
        TorchBackend(plain.setup, "cpu", fixedbase=plain.backend.fixedbase(),
                     mesh=cpu_mesh(1, 2)).fixedbase()


# -- against JAX's own sharded programs (XLA compiles: slow) ------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jax.devices()[:8], data=2, points=4)


@pytest.mark.slow
@pytest.mark.parametrize("shard", ["points", "windows"])
def test_sharded_msm_matches_jax_parallel(basis, jax_mesh, shard):
    from lambdaworks_kzg_tpu.ops import g1_ops as JG, msm as JM
    from lambdaworks_kzg_tpu.parallel import sharded_msm as jax_sharded_msm

    _, _, affine = basis
    jpoints, jvalid = JG.make_points_host(affine)
    points, valid = lb.as_limb_tensor(np.array(jpoints)), torch.from_numpy(np.array(jvalid))
    rng = random.Random(41)
    scalars = [rng.randrange(R) for _ in range(N_DEV)]
    want = jax_sharded_msm(jax_mesh, jpoints, jvalid, JM.scalars_to_device(scalars), C_BITS, shard)
    got = sharded_msm(cpu_mesh(2, 4), points, valid, msm.scalars_to_tensor(scalars), C_BITS, shard)
    assert HC.to_affine(got) == JHC.to_affine(JHC.FP_OPS, want)


@pytest.mark.slow
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_jax_parallel(jax_mesh, inverse):
    from lambdaworks_kzg_tpu.parallel.ntt import sharded_ntt_ints as jax_sharded_ntt_ints

    rng = random.Random(43)
    values = [rng.randrange(R) for _ in range(64)]
    for axis in ("data", "points"):
        want = jax_sharded_ntt_ints(jax_mesh, axis, values, inverse=inverse)
        assert sharded_ntt_ints(cpu_mesh(2, 4), axis, values, inverse=inverse) == want
