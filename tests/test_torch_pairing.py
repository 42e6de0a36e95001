"""The port's device pairing tier against the JAX package, on the CPU.

- `ops/fp2_ops.py`, every function of `ops/tower_ops.py`, `g2_ops.dbl`
  and `g2_ops.add` (exceptional lanes included) and the Miller loop's
  `_dbl_step` / `_add_step` on three lanes are limb-equal to the JAX
  package's eager functions, on inputs carried across by `convert.py`;
- `g2_ops.scalar_mul_fixed` at a small k and `subgroup_mask` on points
  in and out of G2 equal the host oracle (and, in a `slow` test, the JAX
  package's jitted functions, whose XLA-CPU compile takes minutes);
- `_pow_abs`, `lane_product` at an odd B, `final_exp_cubed` and
  `pairing_check` (a true case, a false case, members at infinity) equal
  the port's host pairing (`host/pairing.py`), as the JAX package's
  tests/test_pairing_device.py holds its tier;
- `KZGConfig` and the switch: one true and one false `verify_kzg_proof`
  consensus vector through `EIP4844Context(setup, device="cpu",
  config=KZGConfig(device_pairing=True))` give the vector's verdict and
  JAX `KZG.verify`'s, and both verify entry points take the tier.
Tolerance: none; every value is an exact field element."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import curve as JC
from lambdaworks_kzg_tpu.models import srs as jsrs
from lambdaworks_kzg_tpu.models.kzg import KZG as JaxKZG, HostBackend
from lambdaworks_kzg_tpu.ops import fp2_ops as JF2
from lambdaworks_kzg_tpu.ops import g1_ops as jg1, g2_ops as JG2
from lambdaworks_kzg_tpu.ops import pairing_ops as JPO
from lambdaworks_kzg_tpu.ops import tower_ops as JT
from lambdaworks_kzg_tpu.ops.field_ops import FP as JFP
import lambdaworks_kzg_tpu_torch as port
from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGConfig, convert
from lambdaworks_kzg_tpu_torch.constants import BLS_X, P, R
from lambdaworks_kzg_tpu_torch.host import curve as HC, field as HF, pairing as HP
from lambdaworks_kzg_tpu_torch.models import kzg as port_kzg, srs
from lambdaworks_kzg_tpu_torch.ops import dispatch, fp2_ops as F2, g1_ops, g2_ops, limbs as lb
from lambdaworks_kzg_tpu_torch.ops import pairing_ops as PO, tower_ops as T
from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

from .test_torch_prove import FIXEDBASE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(REPO, "testdata", "consensus", "verify_kzg_proof", "small")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_field_jitted():
    """The JAX package's Fp ops, jitted one by one for this module: its
    eager tower and G2 ops otherwise dispatch every limb op on its own
    (~40 s of this module). A jitted op computes the same integers."""
    names = ("mul", "sqr", "add", "sub", "neg")
    for name in names:
        setattr(JFP, name, jax.jit(getattr(JFP, name)))
    yield
    for name in names:
        delattr(JFP, name)  # back to the class's methods


def _fp2(rng):
    return (rng.randrange(P), rng.randrange(P))


def _fp6(rng):
    return (_fp2(rng), _fp2(rng), _fp2(rng))


def _fp12(rng):
    return (_fp6(rng), _fp6(rng))


def _port2(jax_arr):
    """A JAX Fp2 array -> the port's tensor, through convert.py."""
    return convert.fp2_from_numpy(np.asarray(jax_arr), "cpu")


def _same(port_value, jax_value) -> bool:
    """Limb equality of a port tensor (or nested tuple) and a JAX array
    (or the same nesting), or of two bool masks."""
    if isinstance(port_value, tuple):
        return len(port_value) == len(jax_value) and all(
            _same(p, j) for p, j in zip(port_value, jax_value))
    want = np.asarray(jax_value)
    got = port_value.numpy()
    return want.shape == got.shape and np.array_equal(got, want.astype(got.dtype))


def _twist_points(rng, count):
    """Affine points of G2 ([k] G2 for random k)."""
    return [HC.g2_to_affine(HC.g2_scalar_mul(HC.G2_GENERATOR, rng.randrange(1, R)))
            for _ in range(count)]


def _twist_point_outside_g2(rng):
    """An affine point of the twist that is not in G2."""
    while True:
        x = _fp2(rng)
        y = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(x), x), (4, 4)))
        if y is not None and not HC.g2_in_subgroup(HC.g2_from_affine((x, y))):
            return (x, y)


# -- Fp2 ---------------------------------------------------------------------


def test_fp2_ops_match_jax():
    rng = random.Random(0xF2)
    a_h = [(0, 0), (1, 0), (P - 1, P - 1)] + [_fp2(rng) for _ in range(3)]
    b_h = [_fp2(rng) for _ in range(5)] + [a_h[5]]
    a_j, b_j = JF2.from_host(a_h), JF2.from_host(b_h)
    a, b = convert.fp2_from_numpy(a_j, "cpu"), convert.fp2_from_numpy(b_j, "cpu")
    assert torch.equal(a, F2.from_host(a_h, "cpu")) and F2.to_host(a) == JF2.to_host(a_j)
    for name in ("add", "sub", "mul", "eq"):
        assert _same(getattr(F2, name)(a, b), getattr(JF2, name)(a_j, b_j)), name
    for name in ("neg", "conj", "double", "sqr", "mul_by_nonresidue", "inv", "is_zero"):
        assert _same(getattr(F2, name)(a), getattr(JF2, name)(a_j)), name
    assert F2.is_zero(a).tolist() == [True] + [False] * 5
    assert F2.eq(a, b).tolist() == [False] * 5 + [True]
    for name in ("add", "sub", "mul", "sqr", "neg", "double", "is_zero", "eq"):
        assert getattr(F2.FP2, name) is getattr(F2, name)


def test_fp2_ops_batch_over_leading_axes():
    """Leading axes are independent elements: a [3, 2, L, B] product is the
    three [2, L, B] products."""
    rng = random.Random(0xF3)
    a = torch.stack([F2.from_host([_fp2(rng) for _ in range(2)], "cpu") for _ in range(3)])
    b = F2.from_host([_fp2(rng) for _ in range(2)], "cpu")
    stacked = F2.mul(a, b)
    for i in range(3):
        assert torch.equal(stacked[i], F2.mul(a[i], b))
        assert torch.equal(F2.inv(a)[i], F2.inv(a[i]))


# -- the tower -----------------------------------------------------------------

_TOWER_CASES = ("fp6_add", "fp6_sub", "fp6_neg", "fp6_mul", "fp6_sqr", "fp6_mul_by_v", "fp6_inv",
                "fp6_is_zero", "fp12_mul", "fp12_sqr", "fp12_inv", "fp12_conj", "fp12_cyc_sqr",
                "fp12_eq_one", "fp12_frobenius", "fp12_frobenius_n")


@pytest.fixture(scope="module")
def tower_values():
    """Three lanes of Fp6 and Fp12 values (the last lane zero, and one in
    the Fp12 pair), in the JAX package's arrays and carried across."""
    rng = random.Random(0x612)
    a6 = [_fp6(rng), _fp6(rng), ((0, 0), (0, 0), (0, 0))]
    b6 = [_fp6(rng) for _ in range(3)]
    a12 = [_fp12(rng), _fp12(rng), ((0, 0), (0, 0), (0, 0))]
    a12[2] = (a12[2], a6[2])
    b12 = [_fp12(rng), HF.FP12_ONE, _fp12(rng)]
    j = {"a6": JT.fp6_from_host(a6), "b6": JT.fp6_from_host(b6),
         "a12": JT.fp12_from_host(a12), "b12": JT.fp12_from_host(b12)}
    p = {"a6": tuple(_port2(c) for c in j["a6"]), "b6": tuple(_port2(c) for c in j["b6"]),
         "a12": convert.fp12_from_numpy(j["a12"], "cpu"),
         "b12": convert.fp12_from_numpy(j["b12"], "cpu")}
    host = {"a6": a6, "b6": b6, "a12": a12, "b12": b12}
    return j, p, host


@pytest.mark.parametrize("name", _TOWER_CASES)
def test_tower_op_matches_jax(tower_values, name):
    j, p, _ = tower_values
    args = {"fp6_add": ("a6", "b6"), "fp6_sub": ("a6", "b6"), "fp6_mul": ("a6", "b6"),
            "fp12_mul": ("a12", "b12"), "fp12_eq_one": ("b12",)}.get(
                name, ("a6",) if name.startswith("fp6") else ("a12",))
    extra = (2,) if name == "fp12_frobenius_n" else ()
    got = getattr(T, name)(*(p[k] for k in args), *extra)
    want = getattr(JT, name)(*(j[k] for k in args), *extra)
    assert _same(got, want)


def test_tower_bridges_and_layout(tower_values):
    j, p, host = tower_values
    assert T.fp12_to_host(p["a12"]) == JT.fp12_to_host(j["a12"]) == [
        HF.fp12_mul(v, HF.FP12_ONE) for v in host["a12"]]
    assert T.fp6_to_host(T.fp6_from_host(host["a6"], "cpu")) == host["a6"]
    assert _same(T.fp12_from_host(host["b12"], "cpu"), j["b12"])
    assert _same(T.fp12_one(3, "cpu"), JT.fp12_one(3))
    assert T.fp12_eq_one(p["b12"]).tolist() == [False, True, False]
    flat = T.flatten12(p["a12"])
    assert tuple(flat.shape) == (12, 24, 3)
    assert torch.equal(flat[6 + 2 * 1 + 1], p["a12"][1][1][1])  # a[1][1][1]
    assert _same(T.unflatten12(flat), j["a12"])
    assert _same(T.fp12_mul(p["a12"], T.fp12_inv(p["a12"]))[0][0][:, :, :2],
                 JT.fp12_one(2)[0][0])


# -- G2 ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twist_lanes():
    """Eight lanes of p and q: random points, P == Q, P == -Q, P at
    infinity, Q at infinity, and Z != 1 through one doubling; in both
    packages."""
    rng = random.Random(0x2A)
    pts = _twist_points(rng, 8)
    qts = _twist_points(rng, 8)
    pts[3] = None
    qts[4] = None
    # p is doubled below (Z != 1 on every finite lane): q equals 2p on
    # lane 1 (the doubling fixup) and -2p on lane 2 (infinity)
    two = [HC.g2_to_affine(HC.g2_add(HC.g2_from_affine(pt), HC.g2_from_affine(pt)))
           for pt in pts[1:3]]
    qts[1], qts[2] = two[0], (two[1][0], HF.fp2_neg(two[1][1]))
    jp, jq = (JG2.lift_affine(*JG2.make_points_host(v)) for v in (pts, qts))
    jp = JG2.dbl(jp)
    jq = np.asarray(jq)
    tp, tq = convert.fp2_from_numpy(jp, "cpu"), convert.fp2_from_numpy(jq, "cpu")
    port_q = g2_ops.lift_affine(*g2_ops.make_points_host(qts, "cpu"))
    assert torch.equal(port_q, tq)
    return jp, jq, tp, tq


def test_g2_dbl_and_add_match_jax(twist_lanes):
    jp, jq, tp, tq = twist_lanes
    assert _same(g2_ops.dbl(tp), JG2.dbl(jp))
    total = g2_ops.add(tp, tq)
    assert _same(total, JG2.add(jp, jq))
    assert _same(g2_ops.is_infinity(tq), JG2.is_infinity(jq))
    assert g2_ops.is_infinity(total).tolist() == [False, False, True] + [False] * 5
    want = [HC.g2_add(a, b) for a, b in zip(g2_ops.points_to_host(tp), g2_ops.points_to_host(tq))]
    assert all(HC.g2_points_eq(h, w) for h, w in zip(g2_ops.points_to_host(total), want))
    assert HC.g2_points_eq(g2_ops.points_to_host(total)[1],
                           g2_ops.points_to_host(g2_ops.dbl(tp))[1])


def _g2_subgroup_lanes():
    rng = random.Random(0x5B)
    pts = _twist_points(rng, 2) + [_twist_point_outside_g2(rng), None]
    return pts, [True, True, False, True]


def test_g2_scalar_mul_and_subgroup_mask_match_host():
    pts, in_g2 = _g2_subgroup_lanes()
    jac = g2_ops.lift_affine(*g2_ops.make_points_host(pts, "cpu"))
    got = g2_ops.points_to_host(g2_ops.scalar_mul_fixed(jac, 37))
    for g, pt in zip(got, pts):
        want = HC.G2_INFINITY if pt is None else HC.g2_scalar_mul(HC.g2_from_affine(pt), 37)
        assert HC.g2_points_eq(g, want)
    assert g2_ops.subgroup_mask(jac).tolist() == in_g2


@pytest.mark.slow  # the JAX functions are jitted: ~90 s and ~130 s of XLA-CPU compile
def test_g2_scalar_mul_and_subgroup_mask_match_jax():
    pts, in_g2 = _g2_subgroup_lanes()
    jac_j = JG2.lift_affine(*JG2.make_points_host(pts))
    jac = convert.fp2_from_numpy(np.asarray(jac_j), "cpu")
    assert _same(g2_ops.scalar_mul_fixed(jac, 37), JG2.scalar_mul_fixed(jac_j, 37))
    assert _same(g2_ops.subgroup_mask(jac), JG2.subgroup_mask(jac_j))
    assert g2_ops.subgroup_mask_definitional(jac).tolist() == in_g2


# -- the Miller loop's steps -------------------------------------------------------


def test_miller_steps_match_jax():
    """_dbl_step and _add_step on three lanes (projective T with Z != 1)."""
    rng = random.Random(0xD5)
    g1 = [HC.to_affine(HC.point_scalar_mul(HC.G1_GENERATOR, rng.randrange(1, R)))
          for _ in range(3)]
    q = _twist_points(rng, 3)
    t = [HC.g2_scalar_mul(HC.g2_from_affine(pt), 3) for pt in q]  # Jacobian, Z != 1
    xp_j, yp_j = (jg1.FP.to_mont_host([pt[k] for pt in g1]) for k in range(2))
    t_j = tuple(JF2.from_host([pt[k] for pt in t]) for k in range(3))
    q_j = tuple(JF2.from_host([pt[k] for pt in q]) for k in range(2))
    xp, yp = (lb.as_limb_tensor(v, "cpu") for v in (xp_j, yp_j))
    t_p = tuple(_port2(c) for c in t_j)
    q_p = tuple(_port2(c) for c in q_j)
    assert _same(PO._dbl_step(t_p, xp, yp), JPO._dbl_step(t_j, xp_j, yp_j))
    assert _same(PO._add_step(t_p, q_p, xp, yp), JPO._add_step(t_j, q_j, xp_j, yp_j))
    assert PO._LOOP_BITS == JPO._LOOP_BITS.astype(int).tolist()
    assert PO._X_BITS == JPO._X_BITS.astype(int).tolist()
    assert PO._XM1_BITS == JPO._XM1_BITS.astype(int).tolist()


# -- the final exponentiation and the check against the host pairing ------------


def test_pow_abs_and_lane_product_match_host():
    rng = random.Random(0xE7)
    vals = [_fp12(rng) for _ in range(3)]
    # the easy part puts a value in the cyclotomic subgroup, where _pow_abs holds
    easy = [HF.fp12_mul(HF.fp12_frobenius_n(t, 2), t)
            for t in (HF.fp12_mul(HF.fp12_conj(v), HF.fp12_inv(v)) for v in vals[:2])]
    m = T.fp12_from_host(easy, "cpu")
    got = T.fp12_to_host(PO._pow_abs(m, PO._X_BITS))
    assert got == [HF.fp12_pow(e, -BLS_X) for e in easy]
    prod = HF.fp12_mul(HF.fp12_mul(vals[0], vals[1]), vals[2])
    assert T.fp12_to_host(PO.lane_product(T.fp12_from_host(vals, "cpu"))) == [prod]


def test_final_exp_cubed_matches_host():
    """FE(f)^3 on each lane equals the host's final exponentiation cubed,
    for any f (the easy part lands every f in the cyclotomic subgroup)."""
    rng = random.Random(0xFE)
    vals = [_fp12(rng), _fp12(rng)]
    got = T.fp12_to_host(PO.final_exp_cubed(T.fp12_from_host(vals, "cpu")))
    for g, v in zip(got, vals):
        h = HP.final_exponentiation(v)
        assert g == HF.fp12_mul(HF.fp12_sqr(h), h)


def test_pairing_check_with_members_at_infinity_matches_host():
    """e(-[ab]G, G2) e([a]G, [b]G2) e(O, G2) == 1 at an odd B: the lane
    with a member at infinity has Miller value one, and FE^3 of the
    product equals the host pairing's value cubed."""
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pa, qb = HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29)
    g1s = [HC.point_neg(HC.point_scalar_mul(G, 13 * 29)), pa, (1, 1, 0)]
    aff, valid = g1_ops.make_points_host(
        [None if HC.is_infinity(p) else HC.to_affine(p) for p in g1s])
    ps = g1_ops.lift(lb.as_limb_tensor(aff, "cpu"), torch.from_numpy(valid))
    qs = g2_ops.lift_affine(*g2_ops.make_points_host(
        [HC.g2_to_affine(G2), HC.g2_to_affine(qb), HC.g2_to_affine(G2)], "cpu"))
    f = dispatch.pairing_miller_loop(ps, qs)  # the routes pairing_check takes
    assert torch.equal(f[..., 2:], T.flatten12(T.fp12_one(1, "cpu")))
    fe, ok = dispatch.pairing_final_exp(f)
    assert ok.tolist() == [True]
    host = HP.pairing_batch(list(zip(g1s, [G2, qb, G2])))
    assert host == HF.FP12_ONE
    assert T.fp12_to_host(T.unflatten12(fe)) == [host]


def test_pairings_verify_host_points_false_case():
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pa, qb = HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29)
    pbad = HC.point_scalar_mul(G, 13 * 29 + 1)
    assert HP.pairings_verify(pbad, G2, pa, qb) is False
    assert PO.pairings_verify_host_points(pbad, G2, pa, qb, "cpu") is False


# -- the switch --------------------------------------------------------------------


def test_config_reads_the_environment_and_is_exported(monkeypatch):
    monkeypatch.delenv("LWKZG_DEVICE_PAIRING", raising=False)
    assert KZGConfig.from_env() == KZGConfig() == port.DEFAULT_CONFIG
    monkeypatch.setenv("LWKZG_DEVICE_PAIRING", "1")
    assert KZGConfig.from_env().device_pairing is True
    monkeypatch.setenv("LWKZG_DEVICE_PAIRING", "0")
    assert KZGConfig.from_env().device_pairing is False
    assert port.KZGConfig is KZGConfig and port.KZG is port_kzg.KZG
    with pytest.raises(ValueError):
        KZGConfig(device_pairing="yes").validate()


@pytest.fixture(scope="module")
def mainnet_setup():
    return srs.load_mainnet_setup()


@pytest.fixture(scope="module")
def jax_mainnet_setup():
    """The JAX package's setup from the committed cache/srs_mainnet.npz:
    its load_mainnet_setup converts testdata/trusted_setup.txt on the
    host (~3 min) in a checkout without its digest-named cache."""
    return jsrs._setup_from_cache(jsrs._MAINNET_CACHE, "mainnet-cache")


def test_device_pairing_routes_both_verify_checks(monkeypatch, mainnet_setup):
    """With the switch on, verify and verify_batch call
    pairings_verify_host_points on the backend's device and never the
    host pairing; the spy answers with the host pairing."""
    calls = []

    def spy(a1, a2, b1, b2, device):
        calls.append(str(device))
        return HP.pairings_verify(a1, a2, b1, b2)

    def host_pairing(*args):
        raise AssertionError("the host pairing ran with device_pairing set")

    monkeypatch.setattr(PO, "pairings_verify_host_points", spy)
    monkeypatch.setattr(port_kzg, "pairings_verify", host_pairing)

    class Backend:
        device = torch.device("cpu")

        @staticmethod
        def msm(scalars, points):
            return HC.g1_msm(scalars, points)

    kzg = port_kzg.KZG(mainnet_setup, Backend(), KZGConfig(device_pairing=True))
    g = HC.G1_GENERATOR
    assert kzg.verify(g, 0, 1, (1, 1, 0)) is True  # C - [1]G = O: e(O, .) e(O, .)
    assert kzg.verify_batch([g], [0], [1], [(1, 1, 0)], [1]) is True
    assert calls == ["cpu", "cpu"]


def _vector(name):
    case = load_case(os.path.join(VECTORS, name, "data.yaml"))
    inp = case["input"]
    return (inp["commitment"], inp["z"], inp["y"], inp["proof"]), case["output"]


@pytest.mark.parametrize("name", ["verify_kzg_proof_case_correct_proof_0b16242de3e9c686",
                                  "verify_kzg_proof_case_incorrect_proof_0b16242de3e9c686"])
def test_verify_vector_through_the_device_tier(mainnet_setup, jax_mainnet_setup, name):
    args, want = _vector(name)
    backend = TorchBackend(mainnet_setup, "cpu",
                           fixedbase=convert.fixedbase_from_npz(FIXEDBASE, "cpu"))
    ctx = EIP4844Context(mainnet_setup, backend=backend, config=KZGConfig(device_pairing=True))
    assert ctx.kzg.config.device_pairing
    assert ctx.verify_kzg_proof(*args) is want
    jkzg = JaxKZG(jax_mainnet_setup, HostBackend(jax_mainnet_setup))
    commitment, z, y, proof = args
    verdict = jkzg.verify(JC.decompress_g1(commitment), int.from_bytes(z, "little"),
                          int.from_bytes(y, "little"), JC.decompress_g1(proof))
    assert verdict is want
