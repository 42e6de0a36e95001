"""The port's end-of-round measurement, the counterpart of the repository's
`bench.py`: ONE JSON line of the card's own numbers, the last line on
stdout; progress goes to stderr.

    python3 -m lambdaworks_kzg_tpu_torch.bench [--reps N] [--seed S]
    python3 -m lambdaworks_kzg_tpu_torch.bench --device cpu --setup testdata/trusted_setup_4.txt \\
        --batch 2 --msm-log2 6 --reps 1

bench.py's keys keep their names and units, so the two lines read side
by side: `value` (`metric` blob_to_kzg_commitment, ms/blob: the best of 5
warm calls), `compile_s` (the first call in the process, beside
`build_s` / `native_build_s` from `kernels.build()` / `native.build()`,
`build_warm` and `context_s`), `pipelined_ms_per_blob` (16 commitments'
fixed-base MSMs queued as `TorchBackend.commit_scalars` runs them, one
synchronize), `baseline_ms` / `vs_baseline` (the JAX package's host
Pippenger, `host/curve.g1_pippenger`, on the same blob, its commitment
asserted equal to the card's) with `native_baseline_ms` (the native
tier's `g1_msm_affine` on the same 4096 points), `verify_blob_ms` (best
of 3), `batch16_verify_ms_per_blob` (best of 2), and points per second of
the generic MSM `ops/msm.msm_device` on tensors on the card, CUDA events
around whole calls (no table is built since the generic MSM is JAX's
windowed one): `msm_2e12_pps` (16 calls over the 4096 Lagrange points
queued, one synchronize; each call reads its scalar check back, so the
queue syncs once a call), `msm_2e20_pps` with `msm_2e20_c` (uniform
255-bit scalars as bench.py draws them, c = 8 and c = 12, the better;
`msm_2e20_by_c` both), `msm_2e20_packed248_pps` (random blobs' limbs at
c = 12, 248-bit). The 2^20 inputs are the Lagrange points tiled. Each
best-of takes bench.py's count of calls, or `--reps` where that is
fewer.

`configs` holds BASELINE.json's configurations, a block each with the
same keys: `ok` (the results are right: verdicts true, a tampered input
false, repeated results equal), the host-clock `first_ms`, then the
median, min and max of `--reps` warm calls and `ms_per_blob`, the
profiler's kernels, copies and device busy ms of one call (`device_work`)
and `idle_share` = 1 - busy / median. (a) `compute_kzg_proof` +
`verify_kzg_proof` on `testdata/trusted_setup_4.txt`, converted on the
device into a temporary cache directory (`setup4_convert_s`); (b) one
mainnet `blob_to_kzg_commitment`; (c) `compute_blob_kzg_proof` +
`verify_blob_kzg_proof`; (d) `verify_blob_kzg_proof_batch` over 64
blobs; (e) the sharded 2^16-2^22 sweep across hosts, not run on one card.
`port` holds PERF.md's own metrics: ms per proof single and in a batch of
6, ms per blob committed in a batch of 6, and the launches of one proof.
`launches` counts every kernel's launches over the whole run.

There is no fallback: without CUDA the line is `{"error": "CUDA is not
available", ...}` with no number under `value`, and the exit code 2. A
phase that fails puts `error` in the line beside what was measured
before it, and the exit code is 1. `--device cpu` is an explicit
rehearsal of the control flow at small sizes (`--setup`, `--batch`,
`--msm-log2`, `--reps`) on the plain versions: its line says
`"rehearsal": true` and `"device": "cpu"`, and holds no card figure.
"""

import argparse
import itertools
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import native
from .constants import R
from .host import curve as HC
from .models import srs
from .models.eip4844 import EIP4844Context
from .ops import codec, kernels, limbs as lb, msm
from .ops.field_ops import FP
from .utils import profiling
from .utils.blob import blob_to_evaluations

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")
METRIC, UNIT = "blob_to_kzg_commitment", "ms/blob"
# bench.py's sizes; --batch replaces every one of them
PIPELINED, VERIFY_BATCH, CONFIG_BATCH, PORT_BATCH = 16, 16, 64, 6
# bench.py's best-of counts
BEST_COMMIT, BEST_VERIFY, BEST_BATCH_VERIFY, BEST_MSM = 5, 3, 2, 2
MSM_2E20_WINDOWS = (8, 12)
PACKED_C, PACKED_BITS = 12, 248
# top-level keys that hold a time, a rate or a ratio (> 0 on a good run)
TIMED_KEYS = ("value", "vs_baseline", "baseline_ms", "native_baseline_ms", "context_s", "compile_s",
              "setup4_convert_s", "pipelined_ms_per_blob", "verify_blob_ms",
              "batch16_verify_ms_per_blob", "msm_2e12_pps", "msm_2e20_pps", "msm_2e20_packed248_pps")
BLOCK_TIMED_KEYS = ("first_ms", "median_ms", "min_ms", "max_ms", "ms_per_blob")
PORT_KEYS = ("proof_ms", "batch6_ms_per_proof", "commit_batch6_ms_per_blob")
CONFIGS = ("a_setup4_proof_verify", "b_commit", "c_blob_proof_round_trip", "d_verify_batch64")
SWEEP = "e_sharded_msm_sweep"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def timed_values(line: dict):
    """(key, value) of every time, rate and ratio of a card's line: the
    top-level TIMED_KEYS, the port's medians, mins and maxes, and each
    run block's BLOCK_TIMED_KEYS and device busy ms."""
    for key in TIMED_KEYS:
        yield key, line.get(key)
    for key in PORT_KEYS:
        for stat in ("median_ms", "min_ms", "max_ms"):
            yield f"port.{key}.{stat}", line.get("port", {}).get(key, {}).get(stat)
    for name in CONFIGS:
        block = line.get("configs", {}).get(name, {})
        for key in BLOCK_TIMED_KEYS:
            yield f"configs.{name}.{key}", block.get(key)
        yield f"configs.{name}.busy_ms", (block.get("device_work") or {}).get("busy_ms")


def _rand_blob(n: int, rng) -> bytes:
    """bench.py's blob: 31 random bytes and a zero byte an element."""
    return b"".join(rng.bytes(31) + b"\x00" for _ in range(n))


def _stats(times: list, per: int = 1) -> dict:
    ms = [t / per for t in times]
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms), "ms": ms}


class Bench:
    """One run's sizes, device and clocks; `run` fills `line` as it goes,
    so a failure leaves what was measured before it."""

    def __init__(self, args, line: dict):
        self.args, self.line = args, line
        self.dev = torch.device(args.device)
        self.cuda = self.dev.type == "cuda"
        self.reps = args.reps
        self.rng = np.random.default_rng(args.seed)
        sizes = (PIPELINED, VERIFY_BATCH, CONFIG_BATCH, PORT_BATCH)
        self.pipelined, self.verify_batch, self.config_batch, self.port_batch = (
            sizes if args.batch is None else (args.batch,) * 4)
        line["batches"] = {"pipelined": self.pipelined, "verify": self.verify_batch,
                           "configs_d": self.config_batch, "port": self.port_batch}

    def host_ms(self, fn, reps: int) -> tuple:
        return profiling.host_ms(fn, reps, self.dev)

    def best_ms(self, fn, count: int) -> float:
        """The best host ms of bench.py's `count` calls, at most --reps."""
        return min(self.host_ms(fn, min(count, self.reps))[1])

    def call_ms(self, fn) -> float:
        """One call: CUDA events on a card, the host clock on the CPU."""
        if self.cuda:
            return profiling.events_ms(fn)[1]
        return self.host_ms(fn, 1)[1][0]

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def block(self, what: str, fn, check, blobs: int = 1) -> dict:
        """A configuration's block: fn's first call, `reps` warm calls
        (each result must pass `check`), and one call under the profiler
        on a card."""
        results = []
        _, (first,) = self.host_ms(lambda: results.append(fn()), 1)
        _, times = self.host_ms(lambda: results.append(fn()), self.reps)
        ok = all(check(r) for r in results)
        stats = _stats(times)
        work = profiling.device_work(fn) if self.cuda else None
        busy = work and {k: work[k] for k in ("kernels", "copies", "busy_ms")}
        out = {"what": what, "ok": ok, "blobs": blobs, "reps": self.reps, "first_ms": first,
               "median_ms": stats["median_ms"], "min_ms": stats["min_ms"], "max_ms": stats["max_ms"],
               "ms_per_blob": stats["median_ms"] / blobs, "device_work": busy,
               "idle_share": None if busy is None else 1 - busy["busy_ms"] / stats["median_ms"]}
        log(f"{what}: ok {ok}, first {first:.3f} ms, median {stats['median_ms']:.3f} ms "
            f"(min {stats['min_ms']:.3f}, max {stats['max_ms']:.3f}) of {self.reps}, device {busy}")
        return out

    def run(self) -> None:
        args, line = self.args, self.line
        self.build()
        kernels.reset_counts()  # the run's launches start here
        with tempfile.TemporaryDirectory(prefix="lwkzg_bench_") as tmp:  # never the repo's cache/
            t0 = time.perf_counter()
            setup4 = srs.load_trusted_setup_file(SETUP_4, cache_dir=tmp, device=self.dev)
            line["setup4_convert_s"] = time.perf_counter() - t0
            log(f"{SETUP_4} converted on {self.dev} in {line['setup4_convert_s']:.2f} s")
            if args.setup is None:
                setup = srs.load_mainnet_setup(device=self.dev)
            else:
                setup = srs.load_trusted_setup_file(args.setup, cache_dir=tmp, device=self.dev)
        line["setup"], line["n"] = args.setup or "mainnet", setup.n
        t0 = time.perf_counter()
        ctx = EIP4844Context(setup, device=self.dev)
        line["context_s"] = time.perf_counter() - t0
        ctx4 = ctx if setup4.source_digest == setup.source_digest else EIP4844Context(setup4, device=self.dev)
        self.headline(ctx)
        self.bench_keys(ctx)
        self.configs(ctx, ctx4)
        self.port(ctx)
        line["launches"] = kernels.counts()

    def build(self) -> None:
        line = self.line
        if self.cuda:  # g++ for the native tier beside nvcc, as chip_smoke.py's phase 2
            with ThreadPoolExecutor(1) as pool:
                native_build = pool.submit(native.build)
                built = kernels.build()
                built_native = native_build.result()
            line["build_s"] = built["seconds"]
            line["build_warm"] = not (built["built"] or built_native["built"])
        else:
            built_native = native.build()
            line["build_s"] = None
            line["build_warm"] = not built_native["built"]
        line["native_build_s"] = built_native["seconds"]
        log(f"build: nvcc {line['build_s']} s, g++ {line['native_build_s']} s, "
            f"_build/ warm {line['build_warm']}")

    def headline(self, ctx) -> None:
        """bench.py's `value` and `compile_s`, and the host baselines."""
        line, n = self.line, ctx.n
        self.blobs = [_rand_blob(n, self.rng) for _ in range(4)]
        t0 = time.perf_counter()
        self.commitment = ctx.blob_to_kzg_commitment(self.blobs[0])
        line["compile_s"] = time.perf_counter() - t0
        blobs = itertools.cycle(self.blobs)
        line["value"] = self.best_ms(lambda: ctx.blob_to_kzg_commitment(next(blobs)), BEST_COMMIT)
        log(f"first call {line['compile_s']:.3f} s, best warm {line['value']:.3f} ms/blob")
        evals = blob_to_evaluations(self.blobs[0], n)
        xs, ys = (FP.from_mont_host(ctx.setup.lagrange_points[k]) for k in range(2))
        basis = [(x, y) if v else None for x, y, v in zip(xs, ys, ctx.setup.lagrange_valid)]
        t0 = time.perf_counter()
        host_pt = HC.g1_pippenger(evals, basis)
        line["baseline_ms"] = (time.perf_counter() - t0) * 1e3
        if HC.compress_g1(host_pt) != self.commitment:
            raise AssertionError("the card's commitment differs from the host Pippenger's")
        line["baseline"] = "host Pippenger (host/curve.py g1_pippenger, Python ints, same process)"
        line["vs_baseline"] = line["baseline_ms"] / line["value"]
        t0 = time.perf_counter()
        native_pt = native.g1_msm_affine(evals, basis)
        line["native_baseline_ms"] = (time.perf_counter() - t0) * 1e3
        if native_pt != HC.to_affine(host_pt):
            raise AssertionError("the native tier's MSM differs from the host Pippenger's")
        log(f"host Pippenger {line['baseline_ms']:.1f} ms (equal), native tier "
            f"{line['native_baseline_ms']:.3f} ms (equal)")

    def bench_keys(self, ctx) -> None:
        """bench.py's pipelined, verify and MSM keys."""
        line, n, backend = self.line, ctx.n, ctx.backend
        count = max(self.pipelined, self.verify_batch, self.config_batch, self.port_batch)
        self.batch_blobs = [_rand_blob(n, self.rng) for _ in range(count)]
        self.batch_commitments = ctx.blob_to_kzg_commitment_batch(self.batch_blobs)
        self.batch_proofs = ctx.compute_blob_kzg_proof_batch(self.batch_blobs, self.batch_commitments)
        scalars = backend.blob_scalars(self.batch_blobs[: self.pipelined])

        def pipelined():  # _srs_msm_dispatch: the backend's table, no transfer back
            outs = [msm.msm_fixedbase_device(backend._table, backend._table_valid, d, backend.c)
                    for d in scalars]
            self.sync()
            return outs

        pipelined()  # warm
        line["pipelined_ms_per_blob"] = self.host_ms(pipelined, 1)[1][0] / self.pipelined
        proof = ctx.compute_blob_kzg_proof(self.blobs[0], self.commitment)
        if ctx.verify_blob_kzg_proof(self.blobs[0], self.commitment, proof) is not True:
            raise AssertionError("verify_blob_kzg_proof rejected a proof of the card's")
        line["verify_blob_ms"] = self.best_ms(
            lambda: ctx.verify_blob_kzg_proof(self.blobs[0], self.commitment, proof), BEST_VERIFY)
        k = self.verify_batch
        args = (self.batch_blobs[:k], self.batch_commitments[:k], self.batch_proofs[:k])
        if ctx.verify_blob_kzg_proof_batch(*args) is not True:
            raise AssertionError(f"verify_blob_kzg_proof_batch rejected a batch of {k}")
        line["batch16_verify_ms_per_blob"] = self.best_ms(
            lambda: ctx.verify_blob_kzg_proof_batch(*args), BEST_BATCH_VERIFY) / k
        log(f"pipelined {line['pipelined_ms_per_blob']:.3f} ms/blob; verify_blob "
            f"{line['verify_blob_ms']:.3f} ms; batch of {k} {line['batch16_verify_ms_per_blob']:.3f} ms/blob")
        self.msm_keys(ctx, scalars)

    def msm_keys(self, ctx, scalars) -> None:
        """Points per second of the generic MSM on tensors on the device."""
        line, n, setup = self.line, ctx.n, ctx.setup
        points = lb.as_limb_tensor(setup.lagrange_points, self.dev)
        valid = torch.from_numpy(setup.lagrange_valid.copy()).to(self.dev)
        c = ctx.backend.c

        def small():
            for d in scalars:
                msm.msm_device(points, valid, d, c)
            self.sync()

        msm.msm_device(points, valid, scalars[0], c)  # warm
        line["msm_2e12_pps"] = n * len(scalars) / (self.host_ms(small, 1)[1][0] / 1e3)
        big = 1 << self.args.msm_log2
        if big < n or big % n:
            raise ValueError(f"--msm-log2 {self.args.msm_log2}: 2^k must be a multiple of n = {n}")
        tiles = big // n
        line["msm_log2"] = self.args.msm_log2
        big_pts, big_valid = points.repeat(1, 1, tiles), valid.repeat(tiles)
        # bench.py's standard MSM distribution: uniform 255-bit scalars
        uniform = torch.from_numpy(np.concatenate([
            self.rng.integers(0, 1 << 16, (15, big), dtype=np.uint32),
            self.rng.integers(0, 1 << 15, (1, big), dtype=np.uint32)]).astype(np.int64)).to(self.dev)

        def pps(scalars_big, c_big: int, bits: int) -> float:
            call = lambda: msm.msm_device(big_pts, big_valid, scalars_big, c_big, scalar_bits=bits)  # noqa: E731
            ms = [self.call_ms(call) for _ in range(min(BEST_MSM, self.reps))]
            log(f"2^{self.args.msm_log2} c={c_big} {bits}-bit: {ms} ms (the first the shape's first)")
            return big / (min(ms) / 1e3)

        line["msm_2e20_by_c"] = {str(cb): pps(uniform, cb, 255) for cb in MSM_2E20_WINDOWS}
        best = max(MSM_2E20_WINDOWS, key=lambda cb: line["msm_2e20_by_c"][str(cb)])
        line["msm_2e20_pps"], line["msm_2e20_c"] = line["msm_2e20_by_c"][str(best)], best
        del uniform
        packed = np.concatenate([codec.blob_to_limbs(_rand_blob(n, self.rng), n) for _ in range(tiles)],
                                axis=1)
        line["msm_2e20_packed248_pps"] = pps(lb.as_limb_tensor(packed, self.dev), PACKED_C, PACKED_BITS)
        log(f"msm_2e12_pps {line['msm_2e12_pps']:.0f}, msm_2e20_pps {line['msm_2e20_pps']:.0f} "
            f"(c={best}), packed-248 {line['msm_2e20_packed248_pps']:.0f}")

    def configs(self, ctx, ctx4) -> None:
        """BASELINE.json's configurations (a)-(e)."""
        blocks = self.line["configs"] = {}
        blob4 = _rand_blob(ctx4.n, self.rng)
        commitment4 = ctx4.blob_to_kzg_commitment(blob4)
        z = _rand_blob(1, self.rng)

        def prove_verify():
            proof, y = ctx4.compute_kzg_proof(blob4, z)
            return proof, y, ctx4.verify_kzg_proof(commitment4, z, y, proof)

        proof4, y4, _ = prove_verify()
        wrong_y = ((int.from_bytes(y4, "little") + 1) % R).to_bytes(32, "little")
        tampered = ctx4.verify_kzg_proof(commitment4, z, wrong_y, proof4)
        blocks[CONFIGS[0]] = self.block(
            "compute_kzg_proof + verify_kzg_proof, degree-4 setup", prove_verify,
            lambda r: r == (proof4, y4, True) and tampered is False)

        blob, commitment = self.blobs[0], self.commitment
        blocks[CONFIGS[1]] = self.block("blob_to_kzg_commitment, one blob",
                                        lambda: ctx.blob_to_kzg_commitment(blob),
                                        lambda r: r == commitment)

        def round_trip():
            proof = ctx.compute_blob_kzg_proof(blob, commitment)
            return proof, ctx.verify_blob_kzg_proof(blob, commitment, proof)

        proof, _ = round_trip()
        other = ctx.verify_blob_kzg_proof(self.blobs[1], commitment, proof)
        blocks[CONFIGS[2]] = self.block("compute_blob_kzg_proof + verify_blob_kzg_proof", round_trip,
                                        lambda r: r == (proof, True) and other is False)

        k = self.config_batch
        blobs, cs, ps = self.batch_blobs[:k], self.batch_commitments[:k], self.batch_proofs[:k]
        swapped = ctx.verify_blob_kzg_proof_batch(blobs, cs, [ps[1], ps[0]] + ps[2:])
        blocks[CONFIGS[3]] = self.block(f"verify_blob_kzg_proof_batch, {k} blobs",
                                        lambda: ctx.verify_blob_kzg_proof_batch(blobs, cs, ps),
                                        lambda r: r is True and swapped is False, blobs=k)
        blocks[SWEEP] = {"run": False, "why": "BASELINE.json's sharded MSM sweep (2^16-2^22 points) "
                                              "spans at least two hosts; this run has one host"}

    def port(self, ctx) -> None:
        """PERF.md's own metrics: proofs single and in a batch, a batch's
        commitments, and one proof's launches."""
        k = self.port_batch
        blobs, cs = self.batch_blobs[:k], self.batch_commitments[:k]
        before = kernels.counts()
        ctx.compute_blob_kzg_proof(blobs[0], cs[0])
        after = kernels.counts()
        _, single = self.host_ms(lambda: ctx.compute_blob_kzg_proof(blobs[0], cs[0]), self.reps)
        _, batch = self.host_ms(lambda: ctx.compute_blob_kzg_proof_batch(blobs, cs), self.reps)
        _, commits = self.host_ms(lambda: ctx.blob_to_kzg_commitment_batch(blobs), self.reps)
        self.line["port"] = {
            "proof_ms": _stats(single), "batch6_ms_per_proof": _stats(batch, k),
            "commit_batch6_ms_per_blob": _stats(commits, k),
            "launches_per_proof": {name: after[name] - before[name] for name in after
                                   if after[name] != before[name]}}
        log(f"port: {self.line['port']}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m lambdaworks_kzg_tpu_torch.bench",
                                description="One JSON line of the port's numbers on the card.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: a rehearsal of the control flow on the plain versions, no card figure")
    p.add_argument("--setup", help="a setup file (default: the mainnet setup)")
    p.add_argument("--batch", type=int, help="every batch size (default: bench.py's 16, 64 and 6)")
    p.add_argument("--msm-log2", type=int, default=20, help="the large generic MSM's log2 points")
    p.add_argument("--reps", type=int, default=5, help="warm calls a measurement (at least 1)")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None) -> int:
    try:
        args = _parser().parse_args(argv)
    except SystemExit as e:  # a bad argument still ends in one JSON line
        if not e.code:
            raise
        print(json.dumps({"metric": METRIC, "value": None, "unit": UNIT, "error": "bad arguments"}))
        return 2
    line = {"metric": METRIC, "value": None, "unit": UNIT, "backend": args.device,
            "rehearsal": args.device == "cpu"}
    if args.device == "cpu":
        line["device"], line["card"] = "cpu", None
    elif not torch.cuda.is_available():
        line["error"] = "CUDA is not available"
        print(json.dumps(line))
        return 2
    else:
        line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}
    try:
        if args.reps < 1 or (args.batch is not None and args.batch < 2):
            raise ValueError("--reps must be at least 1 and --batch at least 2")
        if args.device == "cuda":
            line["card"] = profiling.card_line()
            log(line["card"])
        Bench(args, line).run()
    except Exception as e:  # the line carries what was measured before the failure
        traceback.print_exc()
        line["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(line))
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
