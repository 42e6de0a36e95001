"""The port's commit path against the JAX package, on the CPU.

- the blob codec equals `ops/codec.py` and rejects the same blobs;
- a 32-point dev setup, carried across with `convert.py`, commits equal
  to the JAX `EIP4844Context` on its host backend (no XLA compile);
- mainnet consensus vectors through the port with the committed
  fixed-base table (the zero blob, the single-element blob and the four
  invalid ones: a dense blob takes ~30 s of plain PyTorch here, and all
  ten run on the card in chip_smoke.py);
- the package imports with `jax`, `yaml` and `lambdaworks_kzg_tpu`
  blocked (the C ABI's adapter and build module among its modules), and
  its entry points refuse a missing CUDA device unless LWKZG_BACKEND=host
  puts them on the CPU."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.models.eip4844 import EIP4844Context as JaxContext
from lambdaworks_kzg_tpu.models.kzg import HostBackend
from lambdaworks_kzg_tpu.ops import codec as JCODEC
from lambdaworks_kzg_tpu.ops import g1_ops as JG
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError, convert
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.host import curve as HC
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import codec, fr_poly, g1_batch
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_commitment_vector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(REPO, "testdata", "consensus", "blob_to_kzg_commitment", "small")
FIXEDBASE = os.path.join(REPO, "cache", "fixedbase_62bcf72bba2b37b8_c8.npz")
N_DEV = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_blob(rng, n):
    """Canonical elements: 31 random little-endian bytes and a zero top byte."""
    return b"".join(rng.bytes(31) + b"\x00" for _ in range(n))


def test_codec_matches_jax():
    rng = np.random.default_rng(17)
    blob = _rand_blob(rng, 64)
    blob = blob[:-32] + (R - 1).to_bytes(32, "little")
    assert np.array_equal(codec.blob_to_limbs(blob, 64), JCODEC.blob_to_limbs(blob, 64))
    bad = [
        blob[:-32] + b"\xff" * 32,
        blob[:-32] + R.to_bytes(32, "little"),
        blob[:-1],
        blob + b"\x00",
    ]
    for b in bad:
        with pytest.raises(ValueError):
            JCODEC.blob_to_limbs(b, 64)
        with pytest.raises(ValueError):
            codec.blob_to_limbs(b, 64)


@pytest.fixture(scope="module")
def dev_pair():
    """(JAX host-backend context, port CPU context) on one 32-point setup."""
    jax_setup = JSRS.create_dev_setup(N_DEV, secret=0xC0FFEE)
    points, valid = JG.make_points_host(jax_setup.g1_lagrange_brp)
    setup = convert.setup_from_numpy(np.asarray(points), np.asarray(valid), "dev-32")
    jax_ctx = JaxContext(jax_setup, backend=HostBackend(jax_setup))
    return jax_ctx, EIP4844Context(setup, device="cpu")


def test_dev_setup_commitments_match_jax(dev_pair):
    jax_ctx, ctx = dev_pair
    rng = np.random.default_rng(23)
    blobs = [_rand_blob(rng, N_DEV), _rand_blob(rng, N_DEV), b"\x00" * (32 * N_DEV)]
    want = [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    assert [ctx.blob_to_kzg_commitment(b) for b in blobs[:1]] == want[:1]
    assert ctx.blob_to_kzg_commitment_batch(blobs) == want
    assert want[2] == bytes([0xC0]) + bytes(47)
    evals = [int.from_bytes(blobs[0][32 * i : 32 * i + 32], "little") for i in range(N_DEV)]
    assert HC.compress_g1(ctx.backend.commit(evals)) == want[0]
    with pytest.raises(KZGError):
        ctx.blob_to_kzg_commitment(blobs[0][:-32] + b"\xff" * 32)
    with pytest.raises(KZGError):
        ctx.blob_to_kzg_commitment_batch([blobs[0], blobs[1][:-1]])


def test_backend_commits_and_fault_is_not_kzg_error(dev_pair, monkeypatch):
    """TorchBackend.commit_blob(s) equal the JAX context; a ValueError
    from below the blob checks (a wrapper's layout check) is not taken
    for an invalid blob."""
    jax_ctx, ctx = dev_pair
    rng = np.random.default_rng(29)
    blobs = [_rand_blob(rng, N_DEV), _rand_blob(rng, N_DEV)]
    want = [jax_ctx.blob_to_kzg_commitment(b) for b in blobs]
    assert HC.compress_g1(ctx.backend.commit_blob(blobs[0])) == want[0]
    assert [HC.compress_g1(pt) for pt in ctx.backend.commit_blobs(blobs)] == want

    def fault(*args, **kwargs):
        raise ValueError("p must be a CUDA tensor")

    monkeypatch.setattr(ctx.backend, "commit_scalars", fault)
    for call in (ctx.blob_to_kzg_commitment, lambda b: ctx.blob_to_kzg_commitment_batch([b])):
        with pytest.raises(ValueError) as info:
            call(blobs[0])
        assert not isinstance(info.value, KZGError)
        with pytest.raises(KZGError):
            call(blobs[0][:-1])


def test_commit_blobs_equals_commit_blob_per_blob(dev_pair):
    """One batched MSM gives each blob the Jacobian point of its own."""
    _, ctx = dev_pair
    rng = np.random.default_rng(31)
    blobs = [_rand_blob(rng, N_DEV) for _ in range(2)] + [b"\x00" * (32 * N_DEV)]
    assert ctx.backend.commit_blobs(blobs) == [ctx.backend.commit_blob(b) for b in blobs]


def test_mainnet_setup_matches_jax():
    setup = srs.load_mainnet_setup()
    assert setup.source_digest == srs.MAINNET_DIGEST and setup.n == 4096
    jax_setup = JSRS.load_mainnet_setup()
    points, valid = JG.make_points_host(jax_setup.g1_lagrange_brp)
    assert np.array_equal(setup.lagrange_points, np.asarray(points))
    assert np.array_equal(setup.lagrange_valid, np.asarray(valid))


def test_setup_without_cache_raises(tmp_path):
    """A setup with no cache is converted on the device it names: with the
    default device="cuda" and no card that raises, with no CPU fallback,
    and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    text = open(os.path.join(REPO, "testdata", "trusted_setup_4.txt")).read()
    path = tmp_path / "setup.txt"
    path.write_text(text)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srs.load_trusted_setup_file(str(path), cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["setup.txt"]


@pytest.fixture(scope="module")
def mainnet_ctx():
    setup = srs.load_mainnet_setup()
    backend = TorchBackend(setup, "cpu", fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu"))
    return EIP4844Context(setup, backend=backend)


def _vector(name):
    return load_commitment_vector(os.path.join(VECTORS, name, "data.yaml"))


@pytest.mark.parametrize(
    "name",
    [
        "blob_to_kzg_commitment_case_valid_blob_0951cfd9ab47a8d3",  # zero blob
        "blob_to_kzg_commitment_case_valid_blob_94b2a33de83f0ee5",  # one element
        "blob_to_kzg_commitment_case_invalid_blob_4c725b75e928d3e7",
        "blob_to_kzg_commitment_case_invalid_blob_4e21bc7500bbd472",
        "blob_to_kzg_commitment_case_invalid_blob_708ed29af6e589bb",
        "blob_to_kzg_commitment_case_invalid_blob_d3afbd98123a3434",
    ],
)
def test_mainnet_vector_on_cpu(mainnet_ctx, name):
    blob, want = _vector(name)
    if want is None:
        with pytest.raises(KZGError):
            mainnet_ctx.blob_to_kzg_commitment(blob)
    else:
        assert mainnet_ctx.blob_to_kzg_commitment(blob) == want


def test_yaml_reader_matches_yaml():
    paths = sorted(glob.glob(os.path.join(VECTORS, "*", "data.yaml")))
    assert len(paths) == 10
    for path in paths:
        with open(path) as f:
            data = yaml.safe_load(f)
        blob, out = load_commitment_vector(path)
        assert blob == bytes.fromhex(data["input"]["blob"][2:])
        assert out == (None if data["output"] is None else bytes.fromhex(data["output"][2:]))


def test_default_device_refuses_missing_cuda(monkeypatch):
    """A context given no device runs on the card: without CUDA it raises,
    unless LWKZG_BACKEND=host puts it on the CPU; an explicit device beats
    the environment."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    setup = convert.setup_from_numpy(np.zeros((2, 24, 4), np.uint32), np.zeros(4, bool))
    monkeypatch.delenv("LWKZG_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EIP4844Context(setup)
    monkeypatch.setenv("LWKZG_BACKEND", "host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EIP4844Context(setup, device="cuda")
    assert EIP4844Context(setup).backend.device == torch.device("cpu")


def test_decompress_batch_defaults_to_cuda():
    """The batched decompression runs on the card unless given
    device="cpu", as every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    point = bytes([0xC0]) + bytes(47)  # infinity
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g1_batch.decompress_batch([point])
    _, is_inf, err = g1_batch.decompress_batch([point], device="cpu")
    assert is_inf.tolist() == [True] and err.tolist() == [False]


def test_fr_domain_defaults_to_cuda():
    """The Fr evaluation domain lives on the card unless given
    device="cpu", as every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fr_poly.FrDomain(4)
    domain = fr_poly.FrDomain(4, device="cpu")
    assert domain.device == torch.device("cpu") and domain.roots_brp.device == torch.device("cpu")


_BLOCKED_IMPORT_CHECK = r"""
import importlib, importlib.abc, importlib.util, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "yaml", "lambdaworks_kzg_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
repo = sys.argv[1]
sys.path.insert(0, repo)
import lambdaworks_kzg_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
for name, path in (("chip_smoke", "chip_smoke.py"),
                   ("torch_native_asan", os.path.join("scripts", "torch_native_asan.py"))):
    spec = importlib.util.spec_from_file_location(name, os.path.join(repo, path))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
for name in ("ops.ntt", "ops.fp2_ops", "ops.tower_ops", "ops.g2_ops", "ops.pairing_ops",
             "utils.blob", "utils.config", "parallel", "parallel.mesh", "parallel.msm",
             "parallel.ntt", "capi_adapter", "capi", "native", "parallel.distributed",
             "utils.profiling", "utils.build", "fuzz", "fuzz.fuzz_differential",
             "fuzz.gen_corpus", "utils.yaml_vectors", "bench"):
    assert pkg.__name__ + "." + name in sys.modules, name
print("ok")
"""


def test_port_imports_without_jax_yaml_or_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT_CHECK, REPO],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
