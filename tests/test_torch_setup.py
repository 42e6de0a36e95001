"""The port's trusted-setup loading and conversion (`models/srs.py`) on the
CPU, held against the JAX package.

- `load_trusted_setup_file(testdata/trusted_setup_4.txt, cache_dir=tmp,
  device="cpu")` converts the degree-4 setup (batched decompression,
  subgroup check and inverse G1 FFT on the plain versions) into a cache
  file `srs_0f1c825ca54c4fef.npz` whose arrays are byte-equal to those the
  JAX package writes for its own (host) conversion of the file, and
  which the JAX `_setup_from_cache` reads; a second load reads that
  cache, needs no device and rewrites nothing;
- the port's `create_dev_setup(8, secret)` equals the JAX one;
- bad setup files raise `SetupLoadError`: a G1 point off the curve or
  outside G1 (naming its index), a bad G2 point, a wrong line count, a
  G1 count that is not a power of two, and wrong counts for the strict
  byte loader;
- an existing cache file is never overwritten.
The mainnet conversion runs only on the card (tests/test_torch_cuda.py):
the plain versions would take hours here."""

import os

import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import P
from lambdaworks_kzg_tpu.host.field import fp_sqrt
from lambdaworks_kzg_tpu.models import srs as JSRS
from lambdaworks_kzg_tpu.ops import g1_ops as JG
from lambdaworks_kzg_tpu_torch import create_dev_setup, load_trusted_setup_from_bytes
from lambdaworks_kzg_tpu_torch.models import srs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_4 = os.path.join(REPO, "testdata", "trusted_setup_4.txt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(cache dir, setup): the degree-4 file converted once on the CPU."""
    cache_dir = tmp_path_factory.mktemp("srs_cache")
    setup = srs.load_trusted_setup_file(SETUP_4, cache_dir=str(cache_dir), device="cpu")
    return cache_dir, setup


def _setup_lines():
    lines = [ln.strip() for ln in open(SETUP_4) if ln.strip()]
    return lines[2:6], lines[6:]


def _write_setup(path, g1_hex, g2_hex, n1=None):
    path.write_text("\n".join([str(len(g1_hex) if n1 is None else n1), str(len(g2_hex)),
                               *g1_hex, *g2_hex]) + "\n")
    return str(path)


def test_degree4_conversion_matches_jax(converted):
    cache_dir, setup = converted
    assert os.listdir(cache_dir) == ["srs_0f1c825ca54c4fef.npz"]
    path = os.path.join(cache_dir, "srs_0f1c825ca54c4fef.npz")
    g1_bytes, g2_bytes = JSRS._parse_setup_text(open(SETUP_4).read())
    theirs = JSRS.load_trusted_setup_from_bytes(g1_bytes, g2_bytes, use_cache=False,
                                                strict_counts=False)  # the JAX host path
    want = {"lagrange": JSRS._affine_g1_to_u8(theirs.g1_lagrange_brp),
            "monomial": JSRS._affine_g1_to_u8(theirs.g1_monomial),
            "g2": JSRS._affine_g2_to_u8(theirs.g2_monomial)}
    with np.load(path) as got:
        assert sorted(got.files) == ["g2", "lagrange", "monomial"]
        for key in ("lagrange", "monomial", "g2"):
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key
    jax_setup = JSRS._setup_from_cache(path, setup.source_digest)
    points, valid = JG.make_points_host(jax_setup.g1_lagrange_brp)
    assert np.array_equal(setup.lagrange_points, np.asarray(points))
    assert np.array_equal(setup.lagrange_valid, np.asarray(valid))
    assert setup.g1_monomial == jax_setup.g1_monomial
    assert setup.g2_monomial == jax_setup.g2_monomial and len(setup.g2_monomial) == 65
    assert setup.source_digest.startswith("0f1c825ca54c4fef") and setup.n == 4


def test_second_load_reads_the_cache_without_a_device(converted):
    cache_dir, setup = converted
    path = os.path.join(cache_dir, "srs_0f1c825ca54c4fef.npz")
    mtime = os.stat(path).st_mtime_ns
    again = srs.load_trusted_setup_file(SETUP_4, cache_dir=str(cache_dir))  # device="cuda"
    assert np.array_equal(again.lagrange_points, setup.lagrange_points)
    assert again.g1_monomial == setup.g1_monomial and again.g2_monomial == setup.g2_monomial
    assert os.stat(path).st_mtime_ns == mtime


def test_existing_cache_file_is_never_overwritten(tmp_path):
    path = tmp_path / "srs_x.npz"
    path.write_bytes(b"kept")
    srs._write_cache(str(path), [None], [None], [])
    assert path.read_bytes() == b"kept"


def test_create_dev_setup_matches_jax():
    secret = 0x1234567
    mine, theirs = create_dev_setup(8, secret), JSRS.create_dev_setup(8, secret)
    points, valid = JG.make_points_host(theirs.g1_lagrange_brp)
    assert np.array_equal(mine.lagrange_points, np.asarray(points))
    assert np.array_equal(mine.lagrange_valid, np.asarray(valid))
    assert mine.g1_monomial == theirs.g1_monomial
    assert mine.g2_monomial == theirs.g2_monomial
    assert mine.source_digest == theirs.source_digest == "dev-8" and mine.n == 8
    with pytest.raises(srs.SetupLoadError):
        create_dev_setup(6)


def test_bad_setup_files_raise(tmp_path):
    g1_hex, g2_hex = _setup_lines()
    g2_hex = g2_hex[:2]  # [1]_2 and [s]_2 keep each conversion short
    non_square = next(x for x in range(1, 100) if fp_sqrt((x ** 3 + 4) % P) is None)
    off_curve = bytes([0x80]) + non_square.to_bytes(48, "big")[1:]
    outside_g1 = bytes([0x80]) + bytes(47)  # x = 0: (0, 2) is on the curve, not in G1
    cases = [
        (g1_hex[:2] + [off_curve.hex()] + g1_hex[3:], g2_hex, None, "bad g1 point at index 2"),
        ([g1_hex[0], outside_g1.hex()] + g1_hex[2:], g2_hex, None, "bad g1 point at index 1"),
        (g1_hex, [g2_hex[0], "c0" + "00" * 94 + "01"], None, "bad g2 point at index 1"),
        (g1_hex[:3], g2_hex, 4, "line count mismatch"),
        (g1_hex[:3], g2_hex, None, "power of two"),
    ]
    for i, (g1, g2, n1, match) in enumerate(cases):
        path = _write_setup(tmp_path / f"bad{i}.txt", g1, g2, n1)
        with pytest.raises(srs.SetupLoadError, match=match):
            srs.load_trusted_setup_file(path, cache_dir=str(tmp_path / "cache"), device="cpu")
    assert not os.path.exists(tmp_path / "cache")
    with pytest.raises(srs.SetupLoadError, match="bad point counts"):
        load_trusted_setup_from_bytes([bytes.fromhex(h) for h in g1_hex],
                                      [bytes.fromhex(h) for h in g2_hex], device="cpu")
