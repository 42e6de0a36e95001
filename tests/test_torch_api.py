"""The port's public surface against the JAX package's, on the CPU.

- the port's `__all__` holds every name of the JAX package's but
  `HostBackend` (a CPU context is the port's host tier), with the same
  `__version__` and protocol sizes, and `load_trusted_setup` is the
  strict byte loader, as in JAX;
- `load_mainnet_setup()` falls back to `cache/srs_mainnet.npz` when
  `testdata/trusted_setup.txt` is absent, and equals the file's setup;
- `KZGConfig.from_env` reads LWKZG_BACKEND and LWKZG_TRUSTED_SETUP as the
  JAX one does and rejects a bad backend as it does; `device()` and
  `load_setup()` follow them;
- `EIP4844Context.warmup()` on a CPU context of the degree-4 setup runs
  each entry point once, builds no kernel, and loads the native tier and
  the domain's bytes it evaluates over.
"""

import os
import re

import numpy as np
import pytest
import torch

import lambdaworks_kzg_tpu as J
import lambdaworks_kzg_tpu_torch as T
from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.utils.config import KZGConfig as JaxConfig
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGConfig, native
from lambdaworks_kzg_tpu_torch.models import srs
from lambdaworks_kzg_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_public_names_match_jax():
    assert set(J.__all__) - {"HostBackend"} <= set(T.__all__)
    assert all(hasattr(T, name) for name in T.__all__)
    assert T.__version__ == J.__version__
    for name in ("BYTES_PER_BLOB", "BYTES_PER_COMMITMENT", "BYTES_PER_FIELD_ELEMENT",
                 "BYTES_PER_PROOF", "FIELD_ELEMENTS_PER_BLOB"):
        assert getattr(T, name) == getattr(J, name), name
    assert T.load_trusted_setup is T.load_trusted_setup_from_bytes
    assert issubclass(T.SetupLoadError, ValueError) and issubclass(T.KZGError, ValueError)
    with pytest.raises(T.SetupLoadError, match="bad point counts"):
        T.load_trusted_setup([b"\x00" * 48], [b"\x00" * 96])


def test_mainnet_setup_falls_back_to_the_committed_cache(monkeypatch):
    from_file = srs.load_mainnet_setup()
    monkeypatch.setattr(srs, "MAINNET_SETUP_PATH", os.path.join(REPO, "no_such_setup.txt"))
    from_cache = srs.load_mainnet_setup(use_cache=True)
    assert from_cache.source_digest == from_file.source_digest == srs.MAINNET_DIGEST
    assert np.array_equal(from_cache.lagrange_points, from_file.lagrange_points)
    assert np.array_equal(from_cache.lagrange_valid, from_file.lagrange_valid)
    assert from_cache.g1_monomial == from_file.g1_monomial
    assert from_cache.g2_monomial == from_file.g2_monomial
    monkeypatch.setattr(srs, "CACHE_DIR", os.path.join(REPO, "no_such_cache"))
    with pytest.raises(T.SetupLoadError, match="no mainnet trusted setup"):
        srs.load_mainnet_setup()


@pytest.mark.parametrize("backend, setup_path, device", [
    (None, None, "cuda"), ("host", None, "cpu"), ("device", SETUP_4, "cuda"), ("", "", "cuda"),
])
def test_config_reads_the_environment_as_jax(monkeypatch, backend, setup_path, device):
    for name, value in (("LWKZG_BACKEND", backend), ("LWKZG_TRUSTED_SETUP", setup_path)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    ours, theirs = KZGConfig.from_env(), JaxConfig.from_env()
    assert ours.backend == theirs.backend == (backend or None)
    assert ours.trusted_setup_path == theirs.trusted_setup_path == (setup_path or None)
    assert ours.device() == device


def test_config_rejects_a_bad_backend_as_jax(monkeypatch):
    monkeypatch.setenv("LWKZG_BACKEND", "tpu")
    for config in (KZGConfig, JaxConfig):
        with pytest.raises(ValueError, match=re.escape("backend must be host|device|None")):
            config.from_env()
    with pytest.raises(ValueError, match="backend must be"):
        KZGConfig(backend="gpu").validate()


def test_config_loads_the_setup_it_names():
    mainnet = KZGConfig().load_setup()
    assert mainnet.source_digest == srs.MAINNET_DIGEST and mainnet.n == 4096
    named = KZGConfig(trusted_setup_path=srs.MAINNET_SETUP_PATH).load_setup(device="cpu")
    assert np.array_equal(named.lagrange_points, mainnet.lagrange_points)


@pytest.fixture(scope="module")
def setup4(tmp_path_factory):
    """The degree-4 setup, its conversion read from a cache that the JAX
    package's host conversion wrote (the port reads that format; the two
    conversions are held byte-equal in tests/test_torch_setup.py)."""
    g1, g2 = JSRS._parse_setup_text(open(SETUP_4).read())
    theirs = JSRS.load_trusted_setup_from_bytes(g1, g2, use_cache=False, strict_counts=False)
    cache = tmp_path_factory.mktemp("setup4_cache")
    np.savez_compressed(cache / f"srs_{theirs.source_digest[:16]}.npz",
                        lagrange=JSRS._affine_g1_to_u8(theirs.g1_lagrange_brp),
                        monomial=JSRS._affine_g1_to_u8(theirs.g1_monomial),
                        g2=JSRS._affine_g2_to_u8(theirs.g2_monomial))
    return srs.load_trusted_setup_file(SETUP_4, cache_dir=str(cache), device="cuda")  # a cache hit


ENTRY_POINTS = ("blob_to_kzg_commitment", "compute_kzg_proof", "verify_kzg_proof",
                "compute_blob_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch",
                "blob_to_kzg_commitment_batch", "compute_blob_kzg_proof_batch")


def test_warmup_runs_each_entry_point_once(setup4, monkeypatch):
    """On a CPU context (LWKZG_BACKEND=host, no device argument) warmup calls
    each of the six entry points once, the batch APIs not at all without
    batch sizes, and builds no kernel; its three verifications hold. It
    loads the native tier (building it if need be) and fills the domain's
    root bytes, so that no first call waits for either."""
    monkeypatch.setenv("LWKZG_BACKEND", "host")
    ctx = EIP4844Context(setup4)
    assert ctx.backend.device == torch.device("cpu")
    monkeypatch.setattr(kernels, "build", lambda: pytest.fail("a CPU context built the kernels"))
    calls, depth, verdicts = {}, [0], []
    for name in ENTRY_POINTS:
        def counted(*args, _fn=getattr(ctx, name), _name=name):
            if depth[0] == 0:
                calls[_name] = calls.get(_name, 0) + 1
            depth[0] += 1
            try:
                out = _fn(*args)
            finally:
                depth[0] -= 1
            if _name.startswith("verify") and depth[0] == 0:
                verdicts.append(out)
            return out
        setattr(ctx, name, counted)
    monkeypatch.setattr(native, "_lib", None)
    assert "roots_brp_le" not in vars(ctx.backend.domain)
    ctx.warmup()
    assert calls == {name: 1 for name in ENTRY_POINTS[:6]}
    assert verdicts == [True, True, True]
    assert native._lib is not None and "roots_brp_le" in vars(ctx.backend.domain)
