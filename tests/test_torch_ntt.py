"""The port's NTT and blob codecs against the JAX package, on the CPU.

- `host/fft.fr_roots_of_unity` (both directions) and `host/fft.fr_fft`
  equal the JAX package's host functions;
- `ops/ntt.ntt_device` and `ntt_ints` equal the port's `fr_fft` and the
  JAX package's `ops/ntt.ntt_device` limb for limb at n = 8, 64 and 256,
  forward and inverse, and with `scale=False`; the round trip and the
  convolution property of tests/test_ntt.py hold;
- `utils/blob.py` equals the JAX package's on the four cases of
  tests/test_blob_utils.py, and its coefficient bridge equals the NTT on
  the CPU.
Tolerance: none; every value is an exact field element."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import fft as JFFT
from lambdaworks_kzg_tpu.ops import ntt as jntt
from lambdaworks_kzg_tpu.utils import blob as JB
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.host import fft as FFT
from lambdaworks_kzg_tpu_torch.ops import limbs as lb, ntt
from lambdaworks_kzg_tpu_torch.ops.field_ops import FR
from lambdaworks_kzg_tpu_torch.utils import blob as B


@pytest.mark.parametrize("inverse", [False, True])
def test_roots_of_unity_and_fr_fft_match_jax(inverse):
    for order in (1, 2, 16, 4096):
        assert FFT.fr_roots_of_unity(order, inverse) == JFFT.fr_roots_of_unity(order, inverse)
    rng = random.Random(31 + inverse)
    for n in (1, 2, 32):
        values = [rng.randrange(R) for _ in range(n)]
        values[0] = R + 5  # reduced first, as the JAX oracle does
        assert FFT.fr_fft(values, inverse) == JFFT.fr_fft(values, inverse)
    with pytest.raises(ValueError):
        FFT.fr_fft([1, 2, 3])


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_fr_fft_and_jax(n, inverse):
    rng = random.Random(n + 1000 * inverse)
    values = [rng.randrange(R) for _ in range(n)]
    mont = FR.to_mont_host(values)
    got = ntt.ntt_device(lb.as_limb_tensor(mont, "cpu"), inverse=inverse)
    want = np.asarray(jntt.ntt_device(jnp.asarray(mont), inverse=inverse))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert FR.from_mont_host(got) == FFT.fr_fft(values, inverse)
    assert ntt.ntt_ints(values, inverse, device="cpu") == FFT.fr_fft(values, inverse)


def test_ntt_without_scale_matches_jax_on_a_batch():
    """scale=False leaves out 1/n; leading axes are independent transforms."""
    n = 64
    rng = random.Random(5)
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(3)]
    mont = np.stack([FR.to_mont_host(r) for r in rows])  # [3, 16, n]
    got = ntt.ntt_device(lb.as_limb_tensor(mont, "cpu"), inverse=True, scale=False)
    want = np.asarray(jntt.ntt_device(jnp.asarray(mont), inverse=True, scale=False))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for row, out in zip(rows, got):
        assert FR.from_mont_host(out) == [v * n % R for v in FFT.fr_fft(row, inverse=True)]


def test_ntt_roundtrip_and_convolution():
    rng = random.Random(7)
    values = [rng.randrange(R) for _ in range(64)]
    forward = ntt.ntt_ints(values, device="cpu")
    assert ntt.ntt_ints(forward, inverse=True, device="cpu") == values
    n = 32
    f = [rng.randrange(R) for _ in range(n)]
    g = [rng.randrange(R) for _ in range(n)]
    conv = [0] * n
    for i in range(n):
        for j in range(n):
            conv[(i + j) % n] = (conv[(i + j) % n] + f[i] * g[j]) % R
    lhs = [a * b % R for a, b in zip(ntt.ntt_ints(f, device="cpu"), ntt.ntt_ints(g, device="cpu"))]
    assert lhs == ntt.ntt_ints(conv, device="cpu")


def test_ntt_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        ntt.ntt_device(torch.zeros((16, 12), dtype=torch.int64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ntt.ntt_ints([1, 2])


def test_get_plan_is_cached_per_device_and_defaults_to_the_card():
    plan = ntt.get_plan(8, "cpu")
    assert plan is ntt.get_plan(8, torch.device("cpu")) and plan.device.type == "cpu"
    assert plan.brp_idx.tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ntt.get_plan(8)


N = 16


def test_blob_roundtrip_matches_jax():
    rng = random.Random(1)
    evals = [rng.randrange(R) for _ in range(N)]
    blob = B.evaluations_to_blob(evals)
    assert blob == JB.evaluations_to_blob(evals)
    assert B.blob_to_evaluations(blob, N) == evals == JB.blob_to_evaluations(blob, N)


def test_blob_with_size_pads_as_jax():
    blob = B.evaluations_to_blob_with_size([1, 2], N)
    assert blob == JB.evaluations_to_blob_with_size([1, 2], N)
    assert len(blob) == N * 32
    assert B.blob_to_evaluations(blob, N) == [1, 2] + [0] * (N - 2)
    with pytest.raises(ValueError):
        B.evaluations_to_blob_with_size([0] * (N + 1), N)


def test_blob_non_canonical_rejects_as_jax():
    for bad in (b"\xff" * (N * 32), bytes(N * 32 - 1)):
        with pytest.raises(ValueError):
            B.blob_to_evaluations(bad, N)
        with pytest.raises(ValueError):
            JB.blob_to_evaluations(bad, N)


def test_coefficient_bridge_matches_jax_and_the_ntt():
    """coefficients -> blob -> coefficients, equal to the JAX bridge; the
    evaluation at a random z (barycentric, on the blob) equals Horner on
    the coefficients; the device NTT gives the same coefficients."""
    rng = random.Random(2)
    coeffs = [rng.randrange(R) for _ in range(N)]
    blob = B.coefficients_to_blob(coeffs, N)
    assert blob == JB.coefficients_to_blob(coeffs, N)
    assert B.blob_to_coefficients(blob, N) == coeffs == JB.blob_to_coefficients(blob, N)
    z = rng.randrange(R)
    horner = 0
    for c in reversed(coeffs):
        horner = (horner * z + c) % R
    assert FFT.barycentric_evaluate(B.blob_to_evaluations(blob, N), z, N) == horner
    evals_nat = FFT.bit_reversal_permutation(B.blob_to_evaluations(blob, N))
    assert ntt.ntt_ints(evals_nat, inverse=True, device="cpu") == coeffs
    with pytest.raises(ValueError):
        B.coefficients_to_blob([0] * (N + 1), N)
