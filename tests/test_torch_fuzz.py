"""The port's fuzz harnesses (`lambdaworks_kzg_tpu_torch/fuzz/`) on the CPU,
against the JAX package:

- two seeded iterations of `fuzz_differential` on the degree-4 setup
  (`testdata/trusted_setup_4.txt`, converted here into a temporary cache):
  a CPU context and the same context with LWKZG_NATIVE=0 agree on every
  call, and every rejection is a clean one (no finding);
- every call those iterations drew, the mutated and random ones among
  them, gives the JAX package's `HostBackend` context the outcome the
  port gave: the same bytes or verdict, or a rejection in both
  (`KZGError`, or `SetupLoadError` for the setup loader);
- a G1 setup point of the wrong length is a `SetupLoadError`, as in the
  JAX package (the fuzzer's first finding: it was a bare ValueError);
- `gen_corpus`'s consensus corpus is, file for file and byte for byte,
  the one JAX's `fuzz/gen_corpus.corpus_from_vectors` writes;
- the combined C target (`fuzz_capi.c`, replay mode) replays a small
  corpus with LWKZG_BACKEND=host and exits 0 with no internal error; the
  six dedicated targets run only in the `slow` test.
"""

import glob
import importlib.util
import os
import subprocess

import pytest
import torch

from lambdaworks_kzg_tpu import EIP4844Context as JaxContext
from lambdaworks_kzg_tpu import KZGError as JaxKZGError
from lambdaworks_kzg_tpu import load_trusted_setup_file as jax_load_setup_file
from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.models.kzg import HostBackend
from lambdaworks_kzg_tpu_torch import capi
from lambdaworks_kzg_tpu_torch.fuzz import fuzz_differential as F
from lambdaworks_kzg_tpu_torch.fuzz import gen_corpus
from lambdaworks_kzg_tpu_torch.models import srs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, SEED = 2, 16


@pytest.fixture(scope="module")
def jax_ctx():
    setup = jax_load_setup_file(F.SETUP_4)
    return JaxContext(setup, backend=HostBackend(setup))


@pytest.fixture(scope="module")
def setup_cache(tmp_path_factory):
    """One cache for the port's degree-4 conversion, shared by the
    differential and the corpus."""
    return str(tmp_path_factory.mktemp("fuzz_setup"))


@pytest.fixture(scope="module")
def fuzzed(setup_cache):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return F.run(ITERS, SEED, device="cpu", cache_dir=setup_cache, log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)


def _jax_outcome(ctx, fn, args):
    try:
        if fn == "load_trusted_setup":
            try:
                setup = JSRS.load_trusted_setup_from_bytes(*args, use_cache=False, strict_counts=False)
            except JSRS.SetupLoadError:
                return "rejected", "SetupLoadError"
            return "ok", (setup.g1_monomial, setup.g2_monomial)
        return "ok", getattr(ctx, fn)(*args)
    except JaxKZGError:
        return "rejected", "KZGError"


def test_differential_on_cpu_finds_nothing(fuzzed):
    assert fuzzed.findings == []
    assert fuzzed.iterations == ITERS
    assert set(fuzzed.calls) == {"cpu", "cpu, LWKZG_NATIVE=0"}
    assert set(fuzzed.calls.values()) == {len(fuzzed.cases)}
    assert {fn for fn, _, _ in fuzzed.cases} == set(F.ENTRY_POINTS)
    kinds = {ref[0] for _, _, ref in fuzzed.cases}
    assert kinds == {"ok", "rejected"}


def test_every_drawn_call_matches_jax_host_backend(fuzzed, jax_ctx):
    for fn, args, ref in fuzzed.cases:
        assert _jax_outcome(jax_ctx, fn, args) == ref, fn


def test_setup_point_of_wrong_length_is_a_setup_load_error(tmp_path):
    with open(F.SETUP_4, encoding="utf-8") as f:
        g1, g2 = srs._parse_setup_text(f.read())
    for bad in (g1[1][:-1], g1[1] + b"\x00", b""):
        points = [g1[0], bad] + list(g1[2:])
        with pytest.raises(srs.SetupLoadError, match="bad g1 point at index 1"):
            srs.load_trusted_setup_from_bytes(points, g2, use_cache=False, strict_counts=False,
                                              device="cpu", cache_dir=str(tmp_path))
        with pytest.raises(JSRS.SetupLoadError):
            JSRS.load_trusted_setup_from_bytes(points, list(g2), use_cache=False, strict_counts=False)


def test_vector_corpus_equals_jax(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_gen_corpus", os.path.join(REPO, "fuzz", "gen_corpus.py"))
    jax_gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_gen)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    n = gen_corpus.corpus_from_vectors(str(mine))
    assert n == jax_gen.corpus_from_vectors(str(theirs)) and n > 0

    def files(root):
        return {os.path.relpath(p, root): open(p, "rb").read()
                for p in glob.glob(os.path.join(root, "*", "*.bin"))}

    assert files(mine) == files(theirs)
    generated, vectors = gen_corpus.combined_corpus(str(mine))
    assert generated == [] and len(vectors) == len(files(theirs))


def _replay(binary: str, paths, env_backend: str = "host"):
    env = capi.client_env()
    env["LWKZG_BACKEND"] = env_backend
    env["OMP_NUM_THREADS"] = "1"  # one thread, as the fixtures above: tier-1 runs files side by side
    return subprocess.run([binary, *paths], env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def corpus(setup_cache, tmp_path_factory, jax_ctx):
    """The vector seeds and one generated round -> (the directory, the
    combined copies of the generated seeds, of the vector seeds). The
    C program converts nothing: the JAX context has written the degree-4
    setup's conversion into the repository's cache by then."""
    out = str(tmp_path_factory.mktemp("corpus"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gen_corpus.corpus_from_vectors(out)
        gen_corpus.corpus_from_library(out, 1, SEED, device="cpu", cache_dir=setup_cache)
    finally:
        torch.set_num_threads(threads)
    return (out, *gen_corpus.combined_corpus(out))


def test_combined_target_replays_a_corpus(corpus):
    _, generated, vectors = corpus
    # the generated round (degree-4 sizes) and four vector seeds
    picked = generated + sorted(vectors)[:4]
    proc = _replay(capi.build_fuzz()["path"], picked)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert f"replayed {len(picked)} corpus files" in proc.stderr and " 0 internal errors" in proc.stderr


@pytest.mark.slow
def test_dedicated_targets_replay_their_corpora(corpus):
    for target, fn in enumerate(gen_corpus.FNS):
        paths = sorted(glob.glob(os.path.join(corpus[0], fn, "gen_*.bin")))
        proc = _replay(capi.build_fuzz(target)["path"], paths)
        assert proc.returncode == 0, fn + proc.stderr[-4000:]
        assert f"replayed {len(paths)} corpus files" in proc.stderr, fn
