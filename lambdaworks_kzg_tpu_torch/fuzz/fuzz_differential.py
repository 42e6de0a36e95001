"""Differential and robustness fuzzer for the port's seven EIP-4844 entry
points (the JAX repository's `fuzz/fuzz_differential.py`).

Every iteration draws seeded inputs at the setup's size and runs each
call through several ways that must give the same outcome, the first of
them the reference:

  * ``cpu``: a CPU context (the plain versions, the native tier for its
    small work, the host pairing tier);
  * ``<device>, LWKZG_NATIVE=0``: the device's context with the native
    tier off (`native.available()` reads the variable at every call):
    on the CPU the ``cpu`` context, on a card the card's;
  * on a card, ``card``: a context on the card (the kernels, the card's
    pairing), and ``card, host pairing``: the card's backend with
    `KZGConfig(device_pairing=False)`, which runs the three verify
    functions only (it shares the card's backend, so its other calls
    would repeat the card's).

So on a card the pairs are the card against the CPU, the native tier
against LWKZG_NATIVE=0, and the card's pairing against the host tier.

The calls are the valid ones (a blob, its commitment, proofs at a random
z, which may be >= r, and their verifications, a batch of two), one
mutated call per entry point (JAX's `mutate` on some of its arguments,
on one element of a list: a blob of a batch, a point of the setup for
`load_trusted_setup`), and one call of a
random entry point on random bytes of the right sizes. An outcome is a
result (bytes, a (proof, y) pair, a verdict, or a loaded setup's points)
or a rejection: `KZGError`, and `SetupLoadError` for the loader. Any
other exception, and any two ways that disagree, is a finding.

Usage, from the repository root (the degree-4 setup by default, as the
JAX harness uses; the card unless --device cpu):

    python -m lambdaworks_kzg_tpu_torch.fuzz.fuzz_differential [--iters N]
        [--seed S] [--setup PATH] [--device cuda|cpu]

It prints every finding, a summary, and `FINDINGS: <n>` last, and exits
1 when there is a finding.
"""

import argparse
import contextlib
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")

ENTRY_POINTS = (
    "blob_to_kzg_commitment",
    "compute_kzg_proof",
    "compute_blob_kzg_proof",
    "verify_kzg_proof",
    "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch",
    "load_trusted_setup",
)
VERIFY_FNS = ("verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch")


def rand_blob(rng: random.Random, n: int) -> bytes:
    return b"".join(rng.randrange(2**248).to_bytes(31, "little") + b"\x00" for _ in range(n))


def mutate(rng: random.Random, data: bytes) -> bytes:
    """JAX's: 1 to 7 bit flips, deletions and insertions."""
    data = bytearray(data)
    for _ in range(rng.randrange(1, 8)):
        op = rng.randrange(3)
        if op == 0 and data:
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        elif op == 1 and data:
            del data[rng.randrange(len(data))]
        else:
            data.insert(rng.randrange(len(data) + 1), rng.randrange(256))
    return bytes(data)


def mutate_some(rng: random.Random, args: tuple) -> tuple:
    """Mutate each argument with odds 1/2, at least one; in a list, one
    element."""
    chosen = [rng.randrange(2) == 1 for _ in args]
    chosen[rng.randrange(len(args))] = True
    out = []
    for arg, pick in zip(args, chosen):
        if pick and isinstance(arg, list):
            arg = list(arg)
            if arg:
                i = rng.randrange(len(arg))
                arg[i] = mutate(rng, arg[i])
        elif pick:
            arg = mutate(rng, arg)
        out.append(arg)
    return tuple(out)


@contextlib.contextmanager
def native_off():
    """LWKZG_NATIVE=0 for the block."""
    old = os.environ.get("LWKZG_NATIVE")
    os.environ["LWKZG_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LWKZG_NATIVE"]
        else:
            os.environ["LWKZG_NATIVE"] = old


def invoke(ctx, fn: str, args: tuple) -> tuple:
    """One call on a context -> ("ok", result), ("rejected", class name)
    or ("crash", "class: message")."""
    from ..models import srs
    from ..models.eip4844 import KZGError

    try:
        if fn == "load_trusted_setup":
            try:
                setup = srs.load_trusted_setup_from_bytes(*args, use_cache=False, strict_counts=False,
                                                          device=ctx.backend.device)
            except srs.SetupLoadError:
                return "rejected", "SetupLoadError"
            return "ok", (setup.g1_monomial, setup.g2_monomial)
        return "ok", getattr(ctx, fn)(*args)
    except KZGError:
        return "rejected", "KZGError"
    except Exception as e:  # noqa: BLE001 - any other exception is a finding
        return "crash", f"{type(e).__name__}: {e}"


class Fuzzer:
    """The ways of one setup and what they found.

    cases: every (fn, args, reference outcome) run; findings: one line
    each; calls: calls per way; scope: the entry points of a way that
    does not run them all."""

    def __init__(self, setup, device: str = "cuda"):
        from .. import EIP4844Context, KZGConfig

        cpu = EIP4844Context(setup, device="cpu")
        self.ways = {"cpu": lambda fn, args: invoke(cpu, fn, args)}
        if device == "cpu":
            self.ways["cpu, LWKZG_NATIVE=0"] = lambda fn, args: self._off(cpu, fn, args)
        else:
            card = EIP4844Context(setup, device=device)
            host_pairing = EIP4844Context(setup, backend=card.backend,
                                          config=KZGConfig(device_pairing=False))
            self.ways["card"] = lambda fn, args: invoke(card, fn, args)
            self.ways["card, LWKZG_NATIVE=0"] = lambda fn, args: self._off(card, fn, args)
            self.ways["card, host pairing"] = lambda fn, args: invoke(host_pairing, fn, args)
        self.scope = {"card, host pairing": VERIFY_FNS}
        self.n = setup.n
        self.cases, self.findings = [], []
        self.calls = {name: 0 for name in self.ways}
        self.iterations = 0

    @staticmethod
    def _off(ctx, fn, args):
        with native_off():
            return invoke(ctx, fn, args)

    def case(self, fn: str, args: tuple) -> tuple:
        """Run one call on every way -> the reference outcome."""
        outs = {}
        for name, way in self.ways.items():
            if fn in self.scope.get(name, ENTRY_POINTS):
                outs[name] = way(fn, args)
                self.calls[name] += 1
        ref_name = next(iter(outs))
        ref = outs[ref_name]
        for name, out in outs.items():
            if out[0] == "crash":
                self.findings.append(f"[{self.iterations}] CRASH {fn} on {name}: {out[1]}")
            elif out != ref and ref[0] != "crash":
                self.findings.append(f"[{self.iterations}] DIFF {fn}: {name} {_short(out)} "
                                     f"against {ref_name} {_short(ref)}")
        self.cases.append((fn, args, ref))
        return ref

    def iteration(self, rng: random.Random, setup_bytes) -> None:
        """One iteration's valid, mutated and random calls; setup_bytes:
        the setup's (G1, G2) compressed points, which the loader's
        mutations start from."""
        n = self.n
        blobs = [rand_blob(rng, n), rand_blob(rng, n)]
        z = rng.randrange(1 << 255).to_bytes(32, "little")  # >= r about half the time
        cs = [_value(self.case("blob_to_kzg_commitment", (b,)), bytes(48)) for b in blobs]
        ps = [_value(self.case("compute_blob_kzg_proof", (b, c)), bytes(48)) for b, c in zip(blobs, cs)]
        proof, y = _value(self.case("compute_kzg_proof", (blobs[0], z)), (bytes(48), bytes(32)))
        self.case("verify_kzg_proof", (cs[0], z, y, proof))
        self.case("verify_blob_kzg_proof", (blobs[0], cs[0], ps[0]))
        self.case("verify_blob_kzg_proof_batch", (blobs, cs, ps))
        g1, g2 = setup_bytes
        valid = {
            "blob_to_kzg_commitment": (blobs[0],),
            "compute_kzg_proof": (blobs[0], z),
            "compute_blob_kzg_proof": (blobs[0], cs[0]),
            "verify_kzg_proof": (cs[0], z, y, proof),
            "verify_blob_kzg_proof": (blobs[0], cs[0], ps[0]),
            "verify_blob_kzg_proof_batch": (blobs, cs, ps),
            "load_trusted_setup": (list(g1), list(g2)),
        }
        for fn, args in valid.items():
            self.case(fn, mutate_some(rng, args))
        # random bytes of the right sizes through one entry point
        fn = ENTRY_POINTS[rng.randrange(len(ENTRY_POINTS) - 1)]
        sizes = {"blob": 32 * n, "z": 32, "y": 32, "c": 48, "p": 48}
        shape = {"blob_to_kzg_commitment": ("blob",), "compute_kzg_proof": ("blob", "z"),
                 "compute_blob_kzg_proof": ("blob", "c"), "verify_kzg_proof": ("c", "z", "y", "p"),
                 "verify_blob_kzg_proof": ("blob", "c", "p")}.get(fn)
        if shape is None:  # the batch: two of each
            args = tuple([rng.randbytes(sizes[k]) for _ in range(2)] for k in ("blob", "c", "p"))
        else:
            args = tuple(rng.randbytes(sizes[k]) for k in shape)
        self.case(fn, args)
        self.iterations += 1


def _value(outcome: tuple, default):
    """The result of an outcome, or `default` for a rejection."""
    return outcome[1] if outcome[0] == "ok" else default


def _short(outcome: tuple) -> str:
    kind, value = outcome
    if isinstance(value, (bytes, bytearray)):
        value = value.hex()[:24]
    elif isinstance(value, tuple) and value and isinstance(value[0], (bytes, bytearray)):
        value = tuple(v.hex()[:24] for v in value)
    return f"{kind}:{str(value)[:80]}"


def run(iters: int, seed: int = 0, setup_path: str = SETUP_4, device: str = "cuda",
        cache_dir=None, log=print) -> Fuzzer:
    """`iters` iterations from `seed` on the setup at `setup_path` (its
    conversion from the cache in `cache_dir`, default the port's, or made
    on `device`) -> the Fuzzer, with its findings."""
    from ..models import srs

    with open(setup_path, "r", encoding="utf-8") as f:
        setup_bytes = srs._parse_setup_text(f.read())
    setup = srs.load_trusted_setup_file(setup_path, cache_dir=cache_dir, device=device)
    fuzzer = Fuzzer(setup, device)
    rng = random.Random(seed)
    for i in range(iters):
        fuzzer.iteration(rng, setup_bytes)
        if (i + 1) % 10 == 0:
            log(f"  {i + 1}/{iters} iterations, {len(fuzzer.findings)} findings", flush=True)
    return fuzzer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--setup", default=SETUP_4, help="small setups fuzz much faster")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    fuzzer = run(args.iters, args.seed, args.setup, args.device)
    for line in fuzzer.findings:
        print(line)
    print(f"{fuzzer.iterations} iterations, {len(fuzzer.cases)} cases, calls per way {fuzzer.calls}, "
          f"{time.perf_counter() - t0:.1f} s")
    print("FINDINGS:", len(fuzzer.findings))
    return 1 if fuzzer.findings else 0


if __name__ == "__main__":
    sys.exit(main())
