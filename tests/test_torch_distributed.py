"""The port's multi-process tier (`parallel/distributed.py`) executed for
real on the CPU: 1, 2 and 4 localhost processes on gloo, each with one
CPU device, mirroring JAX `tests/test_distributed.py`.

- JAX's case: a dev setup at N = 16, one sharded MSM with the ``points``
  axis across every process (each process builds and runs only its
  shards; one all_gather of the partials crosses the group), equal in
  every process to the host oracle (which every process runs, as in
  JAX's test) and, here, to the JAX package's host oracle;
- a context on the default global mesh (``data`` across processes):
  a batch of 5 commitments (an uneven split), a single commitment (row
  0 alone), the batch's proofs, and a batch verification true and with
  two proofs swapped, byte-equal in every process to one process's
  context without a mesh;
- `initialize()` with no coordinator is a no-op returning False, and
  `global_mesh` without a process group is `make_mesh`.

Tables come from the host oracle (Python ints, as in
tests/test_torch_parallel.py), since the plain build costs ~4 s at any
size; the sharded MSM builds its own for the call, through the plain
version."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from lambdaworks_kzg_tpu.host import curve as JHC
from lambdaworks_kzg_tpu_torch import EIP4844Context
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend, auto_window
from lambdaworks_kzg_tpu_torch.parallel import distributed, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SECRET, SEED = 16, 0xD15C0, 77

# shared by the workers and the one-process reference below
_COMMON = r"""
import random

import torch

from lambdaworks_kzg_tpu_torch.constants import R, num_windows
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.ops import g1_ops, limbs as lb


def host_table(lagrange_aff, c):
    cols = []
    for pt in lagrange_aff:
        cur, col = HC.from_affine(pt), []
        for _ in range(num_windows(c)):
            col.append(HC.to_affine(cur))
            for _ in range(c):
                cur = HC.point_double(cur)
        cols.append(col)
    table, valid = g1_ops.make_points_host([col[w] for w in range(num_windows(c)) for col in cols])
    return lb.as_limb_tensor(table), torch.from_numpy(valid)


def basis_affine(setup):
    jac = g1_ops.points_to_host(g1_ops.lift(lb.as_limb_tensor(setup.lagrange_points),
                                            torch.from_numpy(setup.lagrange_valid.copy())))
    return [HC.to_affine(pt) for pt in jac]


def inputs(n, seed):
    rng = random.Random(seed)
    msm_scalars = [rng.randrange(R) for _ in range(n)]
    msm_scalars[1] = 0
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(n)) for _ in range(5)]
    return msm_scalars, blobs


def entry_points(ctx, blobs):
    cs = ctx.blob_to_kzg_commitment_batch(blobs)
    single = ctx.blob_to_kzg_commitment(blobs[2])
    ps = ctx.compute_blob_kzg_proof_batch(blobs, cs)
    swapped = [ps[1], ps[0]] + ps[2:]
    return {"commitments": [c.hex() for c in cs], "single": single.hex(),
            "proofs": [p.hex() for p in ps],
            "verify": [ctx.verify_blob_kzg_proof_batch(blobs, cs, ps),
                       ctx.verify_blob_kzg_proof_batch(blobs, cs, swapped)]}
"""

_WORKER = _COMMON + r"""
import json
import sys

torch.set_num_threads(1)
from lambdaworks_kzg_tpu_torch.parallel import distributed

coord, world, rank, n, secret, seed = sys.argv[1], *map(int, sys.argv[2:])
assert distributed.initialize(coord, world, rank) is True
assert distributed.is_initialized() and distributed.initialize() is True
assert torch.distributed.get_backend() == "gloo"

from lambdaworks_kzg_tpu_torch import EIP4844Context
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import msm
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend, auto_window
from lambdaworks_kzg_tpu_torch.parallel import sharded_msm

setup = srs.create_dev_setup(n, secret=secret)
affine = basis_affine(setup)
msm_scalars, blobs = inputs(n, seed)

# JAX's case: the points axis spans every process
mesh = distributed.global_mesh(data=1, points=world)
assert mesh.shape == {"data": 1, "points": world} and mesh.rank == rank
assert [mesh.owns(0, p) for p in range(world)] == [p == rank for p in range(world)]
got = sharded_msm(mesh, lb.as_limb_tensor(setup.lagrange_points),
                  torch.from_numpy(setup.lagrange_valid.copy()), msm.scalars_to_tensor(msm_scalars),
                  c=4, shard="points")
want = HC.g1_msm(msm_scalars, affine)
assert HC.points_eq(got, want), "distributed MSM != host oracle"

# the default layout: data across processes, the context on it unchanged
mesh = distributed.global_mesh()
assert mesh.shape == {"data": world, "points": 1}
backend = TorchBackend(setup, "cpu", fixedbase=host_table(affine, auto_window(n)), mesh=mesh)
out = entry_points(EIP4844Context(setup, backend=backend), blobs)
out["msm"] = [str(v) for v in HC.to_affine(got)]
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_process():
    """What one process's context without a mesh gives, and the JAX host
    oracle's MSM."""
    scope = {}
    exec(_COMMON, scope)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        setup = srs.create_dev_setup(N, secret=SECRET)
        affine = scope["basis_affine"](setup)
        msm_scalars, blobs = scope["inputs"](N, SEED)
        backend = TorchBackend(setup, "cpu", fixedbase=scope["host_table"](affine, auto_window(N)))
        out = scope["entry_points"](EIP4844Context(setup, backend=backend), blobs)
    finally:
        torch.set_num_threads(n_threads)
    want = JHC.to_affine(JHC.FP_OPS, JHC.g1_msm(msm_scalars, affine))
    out["msm"] = [str(v) for v in want]
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_processes_match_one_process(tmp_path, one_process, world):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "COORDINATOR_ADDRESS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(world), str(rank), str(N),
                               str(SECRET), str(SEED)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{out}"
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        assert len(lines) == 1, out
        assert json.loads(lines[0][len("RESULT "):]) == one_process, f"rank {rank} of {world}"
    assert one_process["verify"] == [True, False]


def test_initialize_without_coordinator_is_a_no_op(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_initialized()
    mesh = distributed.global_mesh(local_devices=["cpu"] * 4)
    assert mesh == make_mesh(["cpu"] * 4) and mesh.ranks is None
    assert mesh.lead == torch.device("cpu") and mesh.owns(1, 1)
    with pytest.raises(ValueError, match="process count"):
        distributed.initialize("localhost:1")
