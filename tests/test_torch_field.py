"""The port's Montgomery Fp (plain PyTorch) against the JAX field and
Python ints, and the 16 <-> 32-bit limb layout round trip.

Inputs come from a numpy seed and go to both packages as numpy arrays;
all comparisons are exact (these are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.ops.field_ops import FP as JFP
from lambdaworks_kzg_tpu_torch.constants import P
from lambdaworks_kzg_tpu_torch.ops import limbs as lb
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

B = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small int64 ops: torch's thread pool only adds overhead here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_fp(rng, n):
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    vals[:4] = [0, 1, P - 1, P - 2]  # edges: zero, one, the top of the field
    return vals


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(2024)
    a_int, b_int = _rand_fp(rng, B), _rand_fp(rng, B)
    b_int[4] = a_int[4]  # a - b == 0 lane
    a_np, b_np = JFP.to_mont_host(a_int), JFP.to_mont_host(b_int)
    return a_int, b_int, a_np, b_np


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg", "double"])
def test_fp_op_matches_jax_and_ints(operands, op):
    a_int, b_int, a_np, b_np = operands
    ref = {
        "mul": lambda x, y: x * y % P,
        "sqr": lambda x, y: x * x % P,
        "add": lambda x, y: (x + y) % P,
        "sub": lambda x, y: (x - y) % P,
        "neg": lambda x, y: (-x) % P,
        "double": lambda x, y: 2 * x % P,
    }[op]
    unary = op in ("sqr", "neg", "double")
    a_t, b_t = lb.as_limb_tensor(a_np), lb.as_limb_tensor(b_np)
    got = getattr(FP, op)(a_t) if unary else getattr(FP, op)(a_t, b_t)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    want = getattr(JFP, op)(ja) if unary else getattr(JFP, op)(ja, jb)
    assert got.dtype == torch.int64 and tuple(got.shape) == (24, B)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert FP.from_mont_host(got.numpy()) == [ref(x, y) for x, y in zip(a_int, b_int)]


def test_fp_inv_matches_jax_and_ints(operands):
    a_int, _, a_np, _ = operands
    got = FP.inv(lb.as_limb_tensor(a_np))
    want = JFP.inv(jnp.asarray(a_np))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert FP.from_mont_host(got.numpy()) == [pow(x, P - 2, P) for x in a_int]


def test_to_from_mont_match_jax(operands):
    a_int, _, a_np, _ = operands
    plain = lb.ints_to_limbs(a_int, 24)
    got = FP.to_mont(lb.as_limb_tensor(plain))
    assert np.array_equal(got.numpy(), a_np.astype(np.int64))
    back = FP.from_mont(got)
    assert np.array_equal(back.numpy(), np.asarray(JFP.from_mont(jnp.asarray(a_np))).astype(np.int64))
    assert lb.limbs_to_ints(back) == a_int
    assert FP.is_zero(got).tolist() == [x == 0 for x in a_int]


def test_limb_layout_round_trip(operands):
    _, _, a_np, b_np = operands
    x16 = lb.as_limb_tensor(np.stack([a_np, b_np, a_np]))  # [3, 24, B]
    x32 = lb.to_u32_layout(x16)
    assert x32.dtype == torch.int32 and tuple(x32.shape) == (3, 12, B)
    assert x32.is_contiguous()
    # the u32 bit pattern is limb pair (2k, 2k+1) as one word
    words = x32.numpy().view(np.uint32).astype(np.int64)
    assert np.array_equal(words, _pair_words(np.stack([a_np, b_np, a_np])))
    assert torch.equal(lb.to_u16_layout(x32), x16)


def _pair_words(x16: np.ndarray) -> np.ndarray:
    x = x16.astype(np.int64)
    return x[..., 0::2, :] | (x[..., 1::2, :] << 16)


def test_normalize_resolves_long_carry_chains():
    rng = np.random.default_rng(5)
    L, n = 25, 64
    t = rng.choice([0, 0xFFFF, 0x1FFFE, 0x10000, 12345], size=(L, n))
    t[0] = rng.choice([0, 0xFFFF, 0x1FFFF], size=n)
    t[:, 0] = [1] + [0xFFFF] * (L - 1)  # one carry through every limb
    got = lb.limbs_to_ints(lb.normalize(torch.from_numpy(t)))
    want = [sum(int(t[k, j]) << (16 * k) for k in range(L)) % (1 << (16 * L)) for j in range(n)]
    assert got == want
    big = rng.integers(0, 1 << 47, size=(L, n))
    got = lb.limbs_to_ints(lb.normalize(torch.from_numpy(big), rounds=2))
    want = [sum(int(big[k, j]) << (16 * k) for k in range(L)) % (1 << (16 * L)) for j in range(n)]
    assert got == want


def test_constants_match_jax():
    from lambdaworks_kzg_tpu import constants as JC
    from lambdaworks_kzg_tpu_torch import constants as C

    for name in ("P", "R", "BLS_X", "G1_BETA", "G1_GENERATOR_X", "G1_GENERATOR_Y",
                 "FIELD_ELEMENTS_PER_BLOB", "BYTES_PER_BLOB", "BYTES_PER_COMMITMENT", "B_G1"):
        assert getattr(C, name) == getattr(JC, name), name
    for order in (1, 2, 4096, 1 << 32):
        assert C.fr_root_of_unity(order) == JC.fr_root_of_unity(order)
    with pytest.raises(ValueError):
        C.fr_root_of_unity(3)


def test_host_curve_matches_jax_oracle():
    from lambdaworks_kzg_tpu.host import curve as JHC
    from lambdaworks_kzg_tpu_torch.host import curve as HC

    rng = np.random.default_rng(99)
    pts = [HC.point_scalar_mul(HC.G1_GENERATOR, int(k)) for k in rng.integers(1, 1 << 62, 4)]
    pts.append(HC.INFINITY)
    for pt in pts:
        data = HC.compress_g1(pt)
        assert data == JHC.compress_g1(pt)
        back = HC.decompress_g1(data)
        assert HC.points_eq(back, JHC.decompress_g1(data))
        assert HC.points_eq(back, pt)
    for bad in (b"\x00" * 48, bytes([0xC0]) + b"\x01" + bytes(46), bytes([0x9F]) + b"\xff" * 47):
        with pytest.raises(HC.DeserializationError):
            HC.decompress_g1(bad)
        with pytest.raises(JHC.DeserializationError):
            JHC.decompress_g1(bad)
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    aff = [HC.to_affine(p) for p in pts[:4]]
    assert HC.points_eq(HC.g1_msm(scalars, aff), JHC.g1_msm(scalars, aff))
