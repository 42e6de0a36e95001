"""The port's Fr layer on the CPU, around its kernels (`csrc/fr_poly.cu`).

- The plain versions the kernels are held against (`FrDomain.
  evaluate_mont_plain`, `quotient_mont_plain`,
  `quotient_in_domain_mont_plain`, and `FR.to_mont` for `to_mont`) at
  n = 32 and 64, on [16, n] and [B, 16, n], with z outside the domain and
  z at every root, equal the JAX package's host oracles:
  `host/fft.barycentric_evaluate`, `host/field.batch_fr_inv` and
  `HostBackend.quotient`. The `slow` test holds them equal to the JAX
  `FrDomain`'s jitted programs (an XLA compile).
- The kernels' layout: Fr limbs go to the u32 layout and back exactly,
  as the integers they are.
- A CPU `FrDomain` never reaches `kernels`: its wrappers raise here.
- `ops/dispatch.py`'s Fr routes flatten the leading batch dimensions and
  pass each blob's in-domain index: held here against the plain versions
  with stand-ins for the kernels that compute in the kernel layout.
- `chip_smoke.py` counts the kernels' work for their bounds from
  `utils/profiling.py`'s Fr product and squaring.

The kernels themselves run only on the card: `tests/test_torch_cuda.py`
holds them against the plain versions there (`-k fr_`), and
`chip_smoke.py` phase 3 at n = 4096 and 1, 6 and 64 blobs."""

import importlib.util
import os
import random
import types

import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.host import fft as JFFT
from lambdaworks_kzg_tpu.host import field as JF
from lambdaworks_kzg_tpu.models.kzg import HostBackend
from lambdaworks_kzg_tpu_torch.constants import R
from lambdaworks_kzg_tpu_torch.ops import dispatch, fr_poly, kernels, limbs as lb
from lambdaworks_kzg_tpu_torch.ops.field_ops import FR
from lambdaworks_kzg_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOBS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[32, 64])
def case(request):
    """(domain on the CPU, the JAX host oracle, BLOBS seeded blobs of n
    ints, their Montgomery limbs [BLOBS, 16, n], seeded zs outside the
    domain)."""
    n = request.param
    rng = random.Random(n)
    blobs = [[rng.randrange(R) for _ in range(n)] for _ in range(BLOBS)]
    domain = fr_poly.FrDomain(n, "cpu")
    evals_m = lb.as_limb_tensor(np.stack([FR.to_mont_host(b) for b in blobs]))
    return domain, HostBackend(types.SimpleNamespace(n=n)), blobs, evals_m, [
        rng.randrange(R) for _ in range(BLOBS)]


def test_domain_matches_jax_roots(case):
    domain, host, *_ = case
    assert domain.roots_brp_ints == host.roots_brp
    assert FR.from_mont_host(domain.roots_brp) == host.roots_brp
    assert FR.from_mont_host(domain.n_inv) == [pow(domain.n, R - 2, R)]


def test_batch_inv_over_a_batch_matches_jax_batch_fr_inv():
    """batch_inv on [B, 16, 32]: one product tree and one inversion per
    row, each row equal to batch_fr_inv of its values."""
    rng = random.Random(3)
    rows = [[rng.randrange(1, R) for _ in range(29)] + [1, R - 1, 2] for _ in range(BLOBS)]
    got = fr_poly.batch_inv(lb.as_limb_tensor(np.stack([FR.to_mont_host(v) for v in rows])))
    for b, values in enumerate(rows):
        assert FR.from_mont_host(got[b]) == JF.batch_fr_inv(values)


@pytest.mark.parametrize("batched", [False, True])
def test_plain_evaluate_matches_jax_barycentric(case, batched):
    domain, _, blobs, evals_m, zs = case
    z_m, zn1_m = domain.z_consts(zs)
    if batched:
        y = domain.evaluate_mont_plain(evals_m, z_m, zn1_m)  # [B, 16, 1]
        got = [FR.from_mont_host(y[b])[0] for b in range(BLOBS)]
    else:
        got = [FR.from_mont_host(domain.evaluate_mont_plain(evals_m[0], z_m[0], zn1_m[0]))[0]]
    assert got == [JFFT.barycentric_evaluate(b, z, domain.n) for b, z in zip(blobs, zs)][:len(got)]


@pytest.mark.parametrize("batched", [False, True])
def test_plain_quotient_matches_jax_host_quotient(case, batched):
    domain, host, blobs, evals_m, zs = case
    ys = [JFFT.barycentric_evaluate(b, z, domain.n) for b, z in zip(blobs, zs)]
    z_m, _ = domain.z_consts(zs)
    y_m, _ = domain.z_consts(ys)
    if batched:
        q = domain.quotient_mont_plain(evals_m, y_m, z_m)  # [B, 16, n] plain
        got = [lb.limbs_to_ints(q[b]) for b in range(BLOBS)]
    else:
        got = [lb.limbs_to_ints(domain.quotient_mont_plain(evals_m[0], y_m[0], z_m[0]))]
    want = [host.quotient(b, z, y) for b, z, y in zip(blobs, zs, ys)]
    assert got == want[:len(got)]


def test_plain_in_domain_quotient_at_every_root(case):
    """z = w_m for every m at once: the one-hot rows of the identity over
    one blob broadcast [n, 16, n], against HostBackend.quotient at each
    root, with y the stored element."""
    domain, host, blobs, evals_m, _ = case
    n = domain.n
    z_inv = torch.stack([domain.mont([pow(w, R - 2, R)]) for w in domain.roots_brp_ints])
    q = domain.quotient_in_domain_mont_plain(evals_m[0].expand(n, 16, n),
                                             torch.eye(n, dtype=torch.bool), z_inv)
    for m, w in enumerate(domain.roots_brp_ints):
        assert lb.limbs_to_ints(q[m]) == host.quotient(blobs[0], w, blobs[0][m]), m


def test_evaluations_in_and_out_of_the_domain_match_jax(case):
    """The host-facing calls on a CPU domain: evaluate_blobs_plain (a z at
    a root takes the stored element), evaluate and
    quotient_plain_from_mont at a root and outside."""
    domain, host, blobs, evals_m, zs = case
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs]))
    mixed = [zs[0], domain.roots_brp_ints[7], zs[2]]
    want = [JFFT.barycentric_evaluate(b, z, domain.n) for b, z in zip(blobs, mixed)]
    assert domain.evaluate_blobs_plain(plain, mixed) == want
    assert domain.evaluate(blobs[1], mixed[1]) == blobs[1][7]
    for z in mixed[:2]:
        y = JFFT.barycentric_evaluate(blobs[0], z, domain.n)
        got = lb.limbs_to_ints(domain.quotient_plain_from_mont(evals_m[0], z, y))
        assert got == host.quotient(blobs[0], z, y)


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_u32_layout_round_trip_is_exact(lead):
    """Fr limbs [..., 16, n] -> [..., 8, n] int32 words -> back, bit for
    bit, and each word is the integer's 32-bit digit (the top bit set in
    r - 1, 2^255 + 1 and 2^256 - 1)."""
    rng = random.Random(len(lead))
    count = int(np.prod(lead, dtype=np.int64))
    values = [0, 1, R - 1, (1 << 255) + 1, (1 << 256) - 1, 0x80000000]
    values += [rng.randrange(1 << 256) for _ in range(count * 8 - len(values))]
    x16 = lb.as_limb_tensor(lb.ints_to_limbs(values, 16)).T.reshape(lead + (8, 16)).transpose(-1, -2)
    x32 = lb.to_u32_layout(x16)
    assert x32.dtype == torch.int32 and x32.shape == lead + (8, 8) and x32.is_contiguous()
    assert torch.equal(lb.to_u16_layout(x32), x16)
    words = (x32.to(torch.int64) & 0xFFFFFFFF).reshape(-1, 8, 8)
    flat = x16.reshape(-1, 16, 8)
    for b in range(words.shape[0]):
        for i, v in enumerate(lb.limbs_to_ints(flat[b])):
            assert [int(w) for w in words[b, :, i]] == [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def test_cpu_domain_never_reaches_the_kernels(monkeypatch, case):
    """Every Fr wrapper raises here; a CPU domain's calls all run, on the
    plain versions."""
    domain, _, blobs, evals_m, zs = case

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU FrDomain reached a kernel wrapper")

    for name in ("fr_to_mont", "fr_evaluate", "fr_quotient", "fr_quotient_in_domain", "fr_check"):
        monkeypatch.setattr(kernels, name, refuse)
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs]))
    assert torch.equal(domain.to_mont(plain), evals_m)
    z_m, zn1_m = domain.z_consts(zs)
    y_m = domain.evaluate_mont(evals_m, z_m, zn1_m)
    domain.quotient_mont(evals_m, y_m, z_m)
    z_inv = domain.mont([pow(domain.roots_brp_ints[3], R - 2, R)])
    assert torch.equal(domain.quotient_in_domain_mont(evals_m[0], 3, z_inv),
                       domain.quotient_in_domain_mont_plain(evals_m[0], torch.arange(domain.n) == 3, z_inv))
    q, y_m = domain.open_mont(plain, zs)
    assert torch.equal(y_m, domain.evaluate_mont(evals_m, z_m, zn1_m))
    assert torch.equal(q, domain.quotient_mont(evals_m, y_m, z_m))
    domain.evaluate_blobs_plain(plain, zs)
    assert domain.roots_k is None and domain.n_inv_k is None


def _stand_in(plain_fn, domain):
    """A kernel wrapper's stand-in: its kernel-layout arguments to the
    public layout, `plain_fn` on them, the result back to the kernel
    layout, with the wrapper's shape checks."""
    def kernel(*args):
        assert args[0].dim() == 3 and args[0].shape[1] == kernels.FR_NL
        b = args[0].shape[0]
        assert torch.equal(args[-1], domain.roots_k) or args[-1].shape == (kernels.FR_NL, 1)
        ins = [a if isinstance(a, list) else lb.to_u16_layout(a) for a in args]
        out = plain_fn(b, *ins)
        return lb.to_u32_layout(out)
    return kernel


@pytest.mark.parametrize("lead", [(), (1,), (BLOBS,)])
def test_dispatch_routes_flatten_the_batch(monkeypatch, case, lead):
    """dispatch.fr_to_mont, fr_evaluate, fr_quotient and
    fr_quotient_in_domain on leading shapes (), (1,) and (B,), z broadcast
    from [16, 1] where the evaluations carry the batch: the results equal
    the plain versions, and the in-domain route passes each blob's index."""
    domain, _, blobs, evals_m, zs = case
    monkeypatch.setattr(domain, "roots_k", lb.to_u32_layout(domain.roots_brp))
    monkeypatch.setattr(domain, "n_inv_k", lb.to_u32_layout(domain.n_inv))
    seen = {}

    def in_domain(b, evals, m, z_inv, roots):
        seen["m"] = m
        onehot = torch.arange(domain.n)[None, :] == torch.tensor(m)[:, None]
        return domain.quotient_in_domain_mont_plain(evals, onehot, z_inv)

    monkeypatch.setattr(kernels, "fr_to_mont", lambda a: lb.to_u32_layout(FR.to_mont(lb.to_u16_layout(a))))
    monkeypatch.setattr(kernels, "fr_evaluate", _stand_in(
        lambda b, e, z, zn1, roots, n_inv: domain.evaluate_mont_plain(e, z, zn1), domain))
    monkeypatch.setattr(kernels, "fr_quotient", _stand_in(
        lambda b, e, y, z, roots: domain.quotient_mont_plain(e, y, z), domain))
    monkeypatch.setattr(kernels, "fr_quotient_in_domain", _stand_in(in_domain, domain))
    k = int(np.prod(lead, dtype=np.int64))
    ev = evals_m[:k].reshape(lead + (16, domain.n))
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs[:k]])).reshape(ev.shape)
    assert torch.equal(dispatch.fr_to_mont(plain), ev)
    z_m, zn1_m = domain.z_consts(zs[:1])
    z1, zn1 = z_m[0], zn1_m[0]  # [16, 1], broadcast over the batch
    y = dispatch.fr_evaluate(ev, z1, zn1, domain.roots_k, domain.n_inv_k)
    assert y.shape == lead + (16, 1)
    assert torch.equal(y, domain.evaluate_mont_plain(ev, z1.expand(lead + (16, 1)),
                                                     zn1.expand(lead + (16, 1))))
    q = dispatch.fr_quotient(ev, y, z1, domain.roots_k)
    assert torch.equal(q, domain.quotient_mont_plain(ev, y, z1.expand(lead + (16, 1))))
    ms = [(5 * b + 1) % domain.n for b in range(k)]
    onehot = torch.stack([torch.arange(domain.n) == m for m in ms]).reshape(lead + (domain.n,))
    z_inv = torch.stack([domain.mont([pow(domain.roots_brp_ints[m], R - 2, R)]) for m in ms])
    z_inv = z_inv.reshape(lead + (16, 1))
    q_in = dispatch.fr_quotient_in_domain(ev, torch.tensor(ms).reshape(lead).tolist(), z_inv,
                                          domain.roots_k)
    assert seen["m"] == ms
    assert torch.equal(q_in, domain.quotient_in_domain_mont_plain(ev, onehot, z_inv))


@pytest.mark.parametrize("quotient", [True, False])
def test_fr_open_keeps_the_kernel_layout(monkeypatch, case, quotient):
    """dispatch.fr_open, the card's route of FrDomain.open_mont, on
    stand-in kernels: fr_evaluate and fr_quotient take the very tensor
    fr_to_mont returned, z and z^n - 1 come in the kernel layout, and q
    and y equal the CPU domain's open_mont (the plain versions)."""
    domain, _, blobs, evals_m, zs = case
    roots_k, n_inv_k = lb.to_u32_layout(domain.roots_brp), lb.to_u32_layout(domain.n_inv)
    made, took = [], []

    def to_mont(a):
        made.append(lb.to_u32_layout(FR.to_mont(lb.to_u16_layout(a))))
        return made[-1]

    def evaluate(e, z, zn1, roots, n_inv):
        took.append(e)
        return _stand_in(lambda b, e, z, zn1, roots, n_inv: domain.evaluate_mont_plain(e, z, zn1),
                         types.SimpleNamespace(roots_k=roots_k))(e, z, zn1, roots, n_inv)

    def quotient_k(e, y, z, roots):
        took.append(e)
        return _stand_in(lambda b, e, y, z, roots: domain.quotient_mont_plain(e, y, z),
                         types.SimpleNamespace(roots_k=roots_k))(e, y, z, roots)

    monkeypatch.setattr(kernels, "fr_to_mont", to_mont)
    monkeypatch.setattr(kernels, "fr_evaluate", evaluate)
    monkeypatch.setattr(kernels, "fr_quotient", quotient_k)
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs]))
    zz = lb.to_u32_layout(domain._z_pair_host(zs))
    assert zz.shape == (2, BLOBS, kernels.FR_NL, 1)
    q, y = dispatch.fr_open(plain, zz, roots_k, n_inv_k, quotient)
    want_q, want_y = domain.open_mont(plain, zs, quotient)
    assert torch.equal(y, want_y) and y.shape == (BLOBS, 16, 1)
    assert (q is None and want_q is None) if not quotient else torch.equal(q, want_q)
    assert len(made) == 1 and all(t is made[0] for t in took) and len(took) == 1 + quotient


def test_smoke_counts_the_fr_kernels_work():
    """An Fr product is 264 IMADs, a squaring 208 and a reduction alone
    136; the smoke's inversion at its cheapest window costs no more than
    fr::inv's fixed 4-bit window (252 squarings, 73 products) and no less
    than the 254 squarings of r - 2. Each kernel is charged the fewest
    products of its function: the evaluation 3 (n - 1) + 4 a blob (a tree
    of fraction sums), the quotient 3 (n - 1) + n + 1 (Montgomery's trick,
    R^-1 folded into the inversion), the in-domain quotient n more (q_m on
    the q_i), each with one inversion; a quotient reads its evaluations,
    the roots, y and z once and writes its quotients once."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (P.IMAD_PER_FR_MUL, P.IMAD_PER_FR_SQR, P.IMAD_PER_FR_REDC) == (264, 208, 136)
    assert smoke.IMAD_PER_FR_MUL is P.IMAD_PER_FR_MUL and smoke.IMAD_PER_FR_SQR is P.IMAD_PER_FR_SQR
    inv = smoke.fr_inv_imads()
    assert 254 * 208 <= inv <= 252 * 208 + 73 * 264
    n, b = 4096, 6
    nbytes, imads = smoke.fr_kernel_work("fr_quotient", n, b)
    assert nbytes == 2 * b * n * 32 + n * 32 + 2 * b * 32
    assert imads == b * ((3 * (n - 1) + n + 1) * 264 + inv)
    assert smoke.bound(nbytes, imads)["bound_by"] == "operations"
    assert smoke.fr_kernel_work("fr_evaluate", n, b)[1] == b * ((3 * (n - 1) + 4) * 264 + inv)
    assert smoke.fr_kernel_work("fr_quotient_in_domain", n, b)[1] == imads + b * n * 264
    assert smoke.fr_kernel_work("fr_to_mont", n, b) == (2 * b * n * 32, b * n * 264)
    assert smoke.fr_kernel_work("fr_check", n, 1) == (10 * n * 32, n * (2 * 264 + 208 + 136 + inv))


@pytest.mark.slow
def test_plain_versions_match_jax_fr_domain_programs():
    """The plain versions against the JAX FrDomain's jitted programs at
    n = 32 on [B, 16, n] (an XLA compile, hence slow)."""
    import jax.numpy as jnp

    from lambdaworks_kzg_tpu.ops import fr_poly as JFP

    n = 32
    rng = random.Random(71)
    jd, d = JFP.FrDomain(n), fr_poly.FrDomain(n, "cpu")
    evals_m = np.stack([FR.to_mont_host([rng.randrange(R) for _ in range(n)]) for _ in range(BLOBS)])
    zs = [rng.randrange(R) for _ in range(BLOBS)]
    z_m, zn1_m = d.z_consts(zs)
    ev = lb.as_limb_tensor(evals_m)
    y = d.evaluate_mont_plain(ev, z_m, zn1_m)
    want_y = jd._eval_kernel(jnp.asarray(evals_m), jnp.asarray(z_m.numpy().astype(np.uint32)),
                             jnp.asarray(zn1_m.numpy().astype(np.uint32)))
    assert np.array_equal(y.numpy(), np.asarray(want_y))
    q = d.quotient_mont_plain(ev, y, z_m)
    want_q = jd._quotient_kernel(jnp.asarray(evals_m), jnp.asarray(y.numpy().astype(np.uint32)),
                                 jnp.asarray(z_m.numpy().astype(np.uint32)))
    assert np.array_equal(q.numpy(), np.asarray(want_q))
    m = 9
    onehot = np.arange(n) == m
    z_inv = d.mont([pow(d.roots_brp_ints[m], R - 2, R)])
    q_in = d.quotient_in_domain_mont_plain(ev[0], torch.from_numpy(onehot), z_inv)
    want_in = jd._quotient_in_domain_kernel(jnp.asarray(evals_m[0]), jnp.asarray(onehot),
                                            jnp.asarray(z_inv.numpy().astype(np.uint32)))
    assert np.array_equal(q_in.numpy(), np.asarray(want_in))
