"""The port's bench (`python3 -m lambdaworks_kzg_tpu_torch.bench`) and what
it stands on, on the CPU:

- `host/curve.g1_pippenger` (the bench's `baseline_ms`) equals the JAX
  package's host Pippenger and the port's double-and-add `g1_msm` on
  seeded inputs with points at infinity, zero scalars, scalars at and
  above r, and equal points;
- without a card the bench prints one JSON line with `error` and no
  number under `value` and exits 2; a bad argument inside the run exits 1
  with an `error` line;
- the rehearsal (`--device cpu`, the degree-4 setup, batches of 2, a 2^6
  MSM, one rep; ~80 s on one thread, most of it nine plain generic MSMs
  at ~5-9 s each) exits 0 with every key of bench.py and every block of
  BASELINE.json's configurations, each `ok`, and launches no kernel;
- `utils/profiling`'s timers: `host_ms` gives a time a rep, and the card's
  readers raise without a card rather than time the CPU.

No number here is a card's."""

import json
import math
import os
import random
import subprocess
import sys

import pytest
import torch

from lambdaworks_kzg_tpu.host import curve as JC
from lambdaworks_kzg_tpu_torch import bench
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.ops import kernels
from lambdaworks_kzg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX package's bench.py line that the port's line keeps
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline", "baseline_ms", "backend",
                 "compile_s", "pipelined_ms_per_blob", "verify_blob_ms", "batch16_verify_ms_per_blob",
                 "msm_2e12_pps", "msm_2e20_pps", "msm_2e20_c", "msm_2e20_packed248_pps")
REHEARSAL = ["--device", "cpu", "--setup", os.path.join(REPO, "testdata", "trusted_setup_4.txt"),
             "--batch", "2", "--msm-log2", "6", "--reps", "1"]


def _msm_inputs(n: int, seed: int):
    """n affine points (a run of consecutive multiples of G: cheap to make)
    with every 5th one at infinity and every 7th equal to its neighbour,
    and scalars among which zeros, r, values above r and 2^256 - 1."""
    rng = random.Random(seed)
    pt = HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R))
    points = []
    for i in range(n):
        pt = HC.point_add(pt, HC.G1_GENERATOR)
        points.append(None if i % 5 == 4 else HC.to_affine(pt))
    for i in range(1, n, 7):
        points[i] = points[i - 1]
    specials = [0, R, R + 3, 2 * R - 1, (1 << 256) - 1, 1]
    scalars = [specials[i // 3] if i % 3 == 2 and i // 3 < len(specials) else rng.randrange(1 << 256)
               for i in range(n)]
    return scalars, points


@pytest.mark.parametrize("n", [1, 7, 300])
def test_pippenger_matches_jax_and_double_and_add(n):
    scalars, points = _msm_inputs(n, seed=n)
    got = HC.g1_pippenger(scalars, points)
    assert HC.points_eq(got, HC.g1_msm(scalars, points))
    assert HC.to_affine(got) == JC.to_affine(JC.FP_OPS, JC.g1_msm(scalars, points))
    with pytest.raises(ValueError, match="counts differ"):
        HC.g1_pippenger(scalars + [1], points)


def _run_bench(args, env_extra=None, timeout=600):
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env_extra or {})}
    out = subprocess.run([sys.executable, "-m", "lambdaworks_kzg_tpu_torch.bench", *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr
    return out.returncode, json.loads(lines[-1]), out.stderr


@pytest.mark.parametrize("args, env, rc", [
    ([], {"CUDA_VISIBLE_DEVICES": ""}, 2),  # the card's run without a card: no fallback
    (["--device", "cpu", "--reps", "0"], {}, 1),  # a failure inside the run
], ids=["no_card", "failed_run"])
def test_bench_without_a_result_prints_an_error_line(args, env, rc):
    got_rc, line, err = _run_bench(args, env, timeout=120)
    assert got_rc == rc, err
    assert line["error"] and line["value"] is None and line["metric"] == "blob_to_kzg_commitment"
    if rc == 2:
        assert line["error"] == "CUDA is not available" and line["rehearsal"] is False


def test_bench_rehearsal_on_the_cpu():
    rc, line, err = _run_bench(REHEARSAL)
    assert rc == 0, err
    assert "error" not in line, line["error"]
    assert line["rehearsal"] is True and line["device"] == "cpu" and line["backend"] == "cpu"
    assert line["n"] == 4 and line["msm_log2"] == 6 and set(line["batches"].values()) == {2}
    for key in BENCH_PY_KEYS:
        assert key in line, key
    assert line["msm_2e20_c"] in bench.MSM_2E20_WINDOWS
    assert set(line["msm_2e20_by_c"]) == {str(c) for c in bench.MSM_2E20_WINDOWS}
    blocks = line["configs"]
    assert set(blocks) == {*bench.CONFIGS, bench.SWEEP}
    keys = set(blocks[bench.CONFIGS[0]])
    for name in bench.CONFIGS:
        assert set(blocks[name]) == keys, name
        assert blocks[name]["ok"] is True, name
        assert blocks[name]["device_work"] is None and blocks[name]["idle_share"] is None
    assert blocks[bench.CONFIGS[3]]["blobs"] == 2
    assert blocks[bench.SWEEP]["run"] is False and blocks[bench.SWEEP]["why"]
    host_clock = [(k, v) for k, v in bench.timed_values(line) if not k.endswith(".busy_ms")]
    bad = [k for k, v in host_clock if not (isinstance(v, float) and math.isfinite(v) and v > 0)]
    assert not bad, bad
    # the plain versions on the CPU: no kernel ran
    assert line["launches"] == dict.fromkeys((k.name for k in kernels.ALL), 0)
    assert line["port"]["launches_per_proof"] == {}


def test_profiling_readers_on_the_cpu():
    calls = []
    out, times = P.host_ms(lambda: calls.append(1) or len(calls), reps=3, device="cpu")
    assert out == 3 and len(calls) == 3
    assert len(times) == 3 and all(isinstance(t, float) and t >= 0 for t in times)
    if torch.cuda.is_available():
        pytest.skip("a card is present: its readers time it")
    for reader in (lambda: P.device_work(lambda: None), lambda: P.events_ms(lambda: None),
                   lambda: P.time_ms(lambda: None, reps=1), lambda: P.host_ms(lambda: None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reader()
