"""Seed corpora for the C harness `fuzz_capi.c` (the JAX repository's
`fuzz/gen_corpus.py`, with no YAML library and no JAX).

Two sources:

  * the consensus vectors (`testdata/consensus/<fn>/small/*/data.yaml`,
    read by `utils/yaml_vectors.parse_vector`): every vector input that
    parses as hex, lifted byte for byte into its target's corpus as
    `vec_<first 16 hex digits of its SHA-256>.bin` (mainnet sizes, which
    the degree-4 targets reject by size);
  * fresh valid inputs from a port context on the degree-4 setup
    (`testdata/trusted_setup_4.txt`, 4-element blobs, the size the
    targets take), as `gen_<sha16>.bin`;

then every file again under `combined/`, prefixed by its target's
dispatch byte, as `<sha16>.bin`.

Usage, from the repository root (the card unless --device cpu):

    python -m lambdaworks_kzg_tpu_torch.fuzz.gen_corpus [--out DIR]
        [--count N] [--seed S] [--device cuda|cpu]

The default DIR, `lambdaworks_kzg_tpu_torch/_build/corpus`, is
git-ignored.
"""

import argparse
import glob
import hashlib
import os
import random
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
VECTORS = os.path.join(REPO, "testdata", "consensus")
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")
CORPUS = os.path.join(PKG, "_build", "corpus")

FNS = [
    "blob_to_kzg_commitment",
    "compute_kzg_proof",
    "compute_blob_kzg_proof",
    "verify_kzg_proof",
    "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch",
]


def _hx(s) -> bytes:
    return bytes.fromhex(s[2:])


def _vector_input_bytes(fn: str, inp: dict) -> bytes:
    """A vector's input map in the harness's wire layout."""
    if fn == "blob_to_kzg_commitment":
        return _hx(inp["blob"])
    if fn == "compute_kzg_proof":
        return _hx(inp["blob"]) + _hx(inp["z"])
    if fn == "compute_blob_kzg_proof":
        return _hx(inp["blob"]) + _hx(inp["commitment"])
    if fn == "verify_kzg_proof":
        return _hx(inp["commitment"]) + _hx(inp["z"]) + _hx(inp["y"]) + _hx(inp["proof"])
    if fn == "verify_blob_kzg_proof":
        return _hx(inp["blob"]) + _hx(inp["commitment"]) + _hx(inp["proof"])
    if fn == "verify_blob_kzg_proof_batch":
        return (b"".join(_hx(b) for b in inp["blobs"]) + b"".join(_hx(c) for c in inp["commitments"])
                + b"".join(_hx(p) for p in inp["proofs"]))
    raise ValueError(f"no wire layout for {fn}")


def _emit(out_dir: str, fn: str, prefix: str, raw: bytes) -> None:
    target = os.path.join(out_dir, fn)
    os.makedirs(target, exist_ok=True)
    with open(os.path.join(target, f"{prefix}{hashlib.sha256(raw).hexdigest()[:16]}.bin"), "wb") as f:
        f.write(raw)


def corpus_from_vectors(out_dir: str) -> int:
    """The vectors' inputs -> files written."""
    from ..utils.yaml_vectors import parse_vector

    n = 0
    for fn in FNS:
        os.makedirs(os.path.join(out_dir, fn), exist_ok=True)
        for path in sorted(glob.glob(os.path.join(VECTORS, fn, "small", "*", "data.yaml"))):
            with open(path, encoding="utf-8") as f:
                data = parse_vector(f.read())
            try:
                raw = _vector_input_bytes(fn, data["input"])
            except (KeyError, ValueError, TypeError):
                continue  # malformed on purpose: not hex
            _emit(out_dir, fn, "vec_", raw)
            n += 1
    return n


def corpus_from_library(out_dir: str, count: int, seed: int, device: str = "cuda",
                        cache_dir=None) -> int:
    """`count` rounds of fresh valid inputs from a context on `device` at
    the degree-4 size (its setup's conversion cached in `cache_dir`,
    default the port's) -> rounds written."""
    from .. import EIP4844Context, load_trusted_setup_file
    from ..utils.hashing import bls_field_to_bytes

    setup = load_trusted_setup_file(SETUP_4, cache_dir=cache_dir, device=device)
    ctx = EIP4844Context(setup, device=device)
    rng = random.Random(seed)

    def blob():
        return b"".join(rng.randrange(2**248).to_bytes(31, "little") + b"\x00" for _ in range(setup.n))

    for _ in range(count):
        b = blob()
        c = ctx.blob_to_kzg_commitment(b)
        z = bls_field_to_bytes(rng.randrange(2**248))
        proof, y = ctx.compute_kzg_proof(b, z)
        _emit(out_dir, "blob_to_kzg_commitment", "gen_", b)
        _emit(out_dir, "compute_kzg_proof", "gen_", b + z)
        _emit(out_dir, "compute_blob_kzg_proof", "gen_", b + c)
        _emit(out_dir, "verify_kzg_proof", "gen_", c + z + y + proof)
        _emit(out_dir, "verify_blob_kzg_proof", "gen_", b + c + ctx.compute_blob_kzg_proof(b, c))
        blobs = [blob() for _ in range(3)]
        cs = ctx.blob_to_kzg_commitment_batch(blobs)
        ps = ctx.compute_blob_kzg_proof_batch(blobs, cs)
        _emit(out_dir, "verify_blob_kzg_proof_batch", "gen_", b"".join(blobs + cs + ps))
    return count


def combined_corpus(out_dir: str) -> tuple:
    """Every target's seeds again under combined/, behind the target's
    dispatch byte -> (the generated seeds' combined paths, the vector
    seeds'), each in the order written."""
    target = os.path.join(out_dir, "combined")
    os.makedirs(target, exist_ok=True)
    written = {"gen_": [], "vec_": []}
    for i, fn in enumerate(FNS):
        for path in sorted(glob.glob(os.path.join(out_dir, fn, "*.bin"))):
            with open(path, "rb") as f:
                raw = bytes([i]) + f.read()
            combined = os.path.join(target, f"{hashlib.sha256(raw).hexdigest()[:16]}.bin")
            with open(combined, "wb") as f:
                f.write(raw)
            written[os.path.basename(path)[:4]].append(combined)
    return written["gen_"], written["vec_"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=CORPUS)
    ap.add_argument("--count", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    nv = corpus_from_vectors(args.out)
    ng = corpus_from_library(args.out, args.count, args.seed, args.device)
    nc = sum(map(len, combined_corpus(args.out)))
    print(f"corpus: {nv} vector seeds + {ng} generated rounds ({nc} combined copies) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
