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
  with stand-ins for the kernels.
- What `fr_evaluate` and `fr_quotient` rest on, at n = 4, 32 and 4096 over
  the domain's roots: the product of the n denominators is z^n - 1, that
  of an aligned chunk of m bit-reversed roots z^m - w_g, the fraction sum
  gives the barycentric y (and e_m at z = w_m), and the host's table
  holds the powers z^(2^l) and K = 1 / (z^n - 1) in Montgomery form, with
  its sign. A Python-int rendering of each kernel's schedule (its block
  and thread split, the fraction tree up, the tree of inverses down, both
  on the host's table, which they only read) equals the plain versions
  at n = 4 and 32 on several splits and at n = 4096 on the kernels' own;
  it stands in for the kernels in the dispatch routes' tests, so
  `FrDomain.open_mont`'s card route runs here end to end, and the
  quotient's route runs with no evaluation before it.
- What `fr_quotient_in_domain` rests on, z = w_m: prod_{i != m} (z - w_i)
  = n / w_m, so K = w_m / n, and the aligned chunk of s = 2^l roots that
  holds m has product s z^s / z without its zero factor, at every m and
  level for n = 4 and 32 and at four m at 4096; the host's root table
  holds z's powers, K with its R, 1/z and m. The rendering of its
  schedule (the walk down with that one sibling's closed form, then q_m
  from the blocks' sums) equals the plain version at n = 4 and 32 for
  every m on several splits, and at 4096 on the kernel's own; standing
  in for the kernel, it shows the in-domain route as one call on the
  plain limbs, with no conversion of form or layout.
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
    a root takes the stored element), evaluate, and quotient on plain
    limbs at a root and outside."""
    domain, host, blobs, evals_m, zs = case
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs]))
    mixed = [zs[0], domain.roots_brp_ints[7], zs[2]]
    want = [JFFT.barycentric_evaluate(b, z, domain.n) for b, z in zip(blobs, mixed)]
    assert domain.evaluate_blobs_plain(plain, mixed) == want
    assert domain.evaluate(blobs[1], mixed[1]) == blobs[1][7]
    for z in mixed[:2]:
        y = JFFT.barycentric_evaluate(blobs[0], z, domain.n)
        got = lb.limbs_to_ints(domain.quotient(plain[0], z, y))
        assert got == host.quotient(blobs[0], z, y)
    assert domain.evaluate(blobs[0], zs[0]) == want[0]


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
    z_inv = domain.mont([pow(domain.roots_brp_ints[3], R - 2, R)])
    assert torch.equal(domain.quotient_in_domain(plain[0], 3),
                       domain.quotient_in_domain_mont_plain(evals_m[0], torch.arange(domain.n) == 3, z_inv))
    q, y = domain.open_mont(plain, zs)
    z_m, zn1_m = domain.z_consts(zs)
    y_m = domain.evaluate_mont_plain(evals_m, z_m, zn1_m)
    assert torch.equal(y, FR.from_mont(y_m))
    assert torch.equal(q, domain.quotient_mont_plain(evals_m, y_m, z_m))
    y0 = domain.evaluate(blobs[0], zs[0])
    assert [y0] == lb.limbs_to_ints(y[0])
    assert torch.equal(domain.quotient(plain[0], zs[0], y0), q[0])
    assert torch.equal(domain.quotient(plain[0], domain.roots_brp_ints[3], None),
                       domain.quotient_in_domain(plain[0], 3))
    domain.evaluate_blobs_plain(plain, zs)
    assert domain.roots_k is None and domain.n_inv_k is None


# -- the schedules of fr_evaluate and fr_quotient, in Python ints -----------

R_INV = pow(1 << 256, -1, R)


def _mmul(a: int, b: int) -> int:
    """fr::mul on ints: the Montgomery product a b / R mod r."""
    return a * b * R_INV % R


def _log2(x: int) -> int:
    return x.bit_length() - 1


def _kernel_split(n: int) -> tuple:
    """(T, G) as the launchers in csrc/fr_poly.cu choose them: T = min(n,
    256) threads a block, G = 8 blocks a blob from n = 2048 on, else 1."""
    return min(n, 256), 8 if n >= 2048 else 1


def _words_to_ints(words) -> list:
    """[8, W] u32 words (int32 bit patterns) -> W ints."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return [sum(int(w[k, c]) << (32 * k) for k in range(8)) for c in range(w.shape[1])]


def _chunk_complement(acc, i, levels, pw, roots):
    """As csrc/fr_poly.cu chunk_complement: acc times pw[l] - w_((i >> l) ^ 1)
    for l < levels, pw[l] = z^(2^l)."""
    for level in range(levels):
        acc = _mmul(acc, (pw[level] - roots[(i >> level) ^ 1]) % R)
    return acc


def _fraction_up(num, pw, count, level, first, roots):
    """As fraction_up: the numerators num[0 .. count) of the chunks first,
    first + 1, ... at size 2^level -> their union's."""
    h = count // 2
    while h >= 1:
        prod = []
        for u in range(2 * h):
            c = roots[first + (u & ~1)]
            prod.append(_mmul(num[u], (pw[level] - c) % R if u & 1 else (pw[level] + c) % R))
        num[:h] = [(prod[2 * t] + prod[2 * t + 1]) % R for t in range(h)]
        h, level, first = h // 2, level + 1, first >> 1
    return num[0]


def render_evaluate(e, tab, roots, n_inv, n, threads, blocks):
    """fr_evaluate's schedule on one blob: e the n plain evaluations, tab
    its table's L + 1 ints (read only), roots and n_inv Montgomery ints,
    `blocks` blocks of `threads` threads -> y."""
    lg, lt = _log2(blocks), _log2(threads)
    lk = _log2(n) - lt - lg
    pw, tops = tab[: lk + lt + lg], []
    for rank in range(blocks):
        num = []
        for t in range(threads):
            part = 0
            for r in range(1 << lk):
                i = ((rank * threads + t) << lk) + r
                part = (part + _chunk_complement(_mmul(e[i], roots[i]), i, lk, pw, roots)) % R
            num.append(part)
        tops.append(_fraction_up(num, pw, threads, lk, rank * threads, roots))
    # the first block of the cluster goes on
    return _mmul(_fraction_up(tops, pw, blocks, lk + lt, 0, roots), n_inv)


def render_quotient(e, y, tab, roots, n, threads, blocks):
    """fr_quotient's schedule on one blob: e and y plain, the table (read
    only) -> the n plain quotients."""
    lg, lt = _log2(blocks), _log2(threads)
    lk = _log2(n) - lt - lg
    lb_, L = lk + lt, lk + lt + lg
    pw, q = tab[:L], [None] * n
    for rank in range(blocks):
        c = tab[L]
        for level in range(lb_, L):
            c = _mmul(c, (pw[level] - roots[(rank >> (level - lb_)) ^ 1]) % R)
        comp = [None, c] + [None] * (2 * threads)
        h, level = 1, lb_ - 1
        while h < threads:
            for t in range(2 * h):
                comp[2 * h + t] = _mmul(comp[h + (t >> 1)],
                                        (pw[level] - roots[rank * 2 * h + (t ^ 1)]) % R)
            h, level = 2 * h, level - 1
        for t in range(threads):
            for r in range(1 << lk):
                i = ((rank * threads + t) << lk) + r
                inv_i = _chunk_complement(comp[threads + t], i, lk, pw, roots)
                q[i] = _mmul((y - e[i]) % R, inv_i)
    return q


def render_in_domain(e, tab, roots, n, threads, blocks):
    """fr_quotient_in_domain's schedule on one blob: e the n plain
    evaluations, tab its root table's L + 3 ints (z's powers, K = w_m / n,
    1/z, m; read only), roots Montgomery ints -> the n plain quotients.
    The walk down is fr_quotient's from K, but for the sibling chunk of
    2^l that holds m, whose product is held[l] = 2^l z^(2^l) / z; then
    q_m = -(1/z) sum_i q_i w_i over every block's elements (q_m's own
    term is 0: y = e_m)."""
    lg, lt = _log2(blocks), _log2(threads)
    lk = _log2(n) - lt - lg
    lb_, L = lk + lt, lk + lt + lg
    pw, z_inv, m = tab[:L], tab[L + 1], tab[L + 2]
    held = []
    for level in range(L):
        h = _mmul(pw[level], z_inv)
        for _ in range(level):
            h = (h + h) % R
        held.append(h)

    def denom(level, g):
        return held[level] if g == m >> level else (pw[level] - roots[g]) % R

    q, total = [None] * n, 0
    for rank in range(blocks):
        c = tab[L]
        for level in range(lb_, L):
            c = _mmul(c, denom(level, (rank >> (level - lb_)) ^ 1))
        comp = [None, c] + [None] * (2 * threads)
        h, level = 1, lb_ - 1
        while h < threads:
            for t in range(2 * h):
                comp[2 * h + t] = _mmul(comp[h + (t >> 1)], denom(level, rank * 2 * h + (t ^ 1)))
            h, level = 2 * h, level - 1
        for t in range(threads):
            for r in range(1 << lk):
                i = ((rank * threads + t) << lk) + r
                inv_i = comp[threads + t]
                for level in range(lk):
                    inv_i = _mmul(inv_i, denom(level, (i >> level) ^ 1))
                qi = _mmul((e[m] - e[i]) % R, inv_i)
                if i != m:
                    q[i] = qi
                total = (total + _mmul(qi, roots[i])) % R
    q[m] = -_mmul(total, z_inv) % R
    return q


def _render_in_domain_kernel(domain, calls):
    """A stand-in for kernels.fr_quotient_in_domain on CPU tensors: the
    rendering at the kernel's split, with the wrapper's checks."""
    want_roots_k = lb.to_u32_layout(domain.roots_brp)
    roots = _words_to_ints(want_roots_k)
    n = domain.n

    def in_domain(evals, m, table, roots_k):
        calls.append(("fr_quotient_in_domain", evals, table))
        assert evals.dtype == torch.int64 and evals.shape[1:] == (16, n)
        assert table.dtype == torch.int32 and table.shape == (evals.shape[0], 8, domain.levels + 3)
        assert len(m) == evals.shape[0] and all(0 <= i < n for i in m)
        assert torch.equal(roots_k, want_roots_k)
        qs = [render_in_domain(lb.limbs_to_ints(evals[b]), _words_to_ints(table[b]), roots, n,
                               *_kernel_split(n)) for b in range(evals.shape[0])]
        return lb.as_limb_tensor(np.stack([lb.ints_to_limbs(v, 16) for v in qs]))

    return in_domain


def _render_kernels(domain):
    """Stand-ins for kernels.fr_evaluate and kernels.fr_quotient on CPU
    tensors: the renderings at the kernels' split, with the wrappers'
    shapes."""
    roots = _words_to_ints(lb.to_u32_layout(domain.roots_brp))
    n_inv = _words_to_ints(lb.to_u32_layout(domain.n_inv))[0]
    n = domain.n
    calls = []

    def evaluate(evals, table, roots_k, n_inv_k):
        calls.append(("fr_evaluate", evals, table))
        assert evals.dtype == torch.int64 and evals.shape[1:] == (16, n)
        assert table.dtype == torch.int32 and table.shape == (evals.shape[0], 8, domain.levels + 1)
        assert torch.equal(roots_k, lb.to_u32_layout(domain.roots_brp))
        ys = [render_evaluate(lb.limbs_to_ints(evals[b]), _words_to_ints(table[b]), roots, n_inv, n,
                              *_kernel_split(n)) for b in range(evals.shape[0])]
        return lb.as_limb_tensor(lb.ints_to_limbs(ys, 16)).T.reshape(-1, 16, 1).contiguous()

    def quotient(evals, y, table, roots_k):
        calls.append(("fr_quotient", evals, table))
        assert y.shape == (evals.shape[0], 16, 1) and y.dtype == torch.int64
        qs = [render_quotient(lb.limbs_to_ints(evals[b]), lb.limbs_to_ints(y[b])[0],
                              _words_to_ints(table[b]), roots, n, *_kernel_split(n))
              for b in range(evals.shape[0])]
        return lb.as_limb_tensor(np.stack([lb.ints_to_limbs(v, 16) for v in qs]))

    return evaluate, quotient, calls


@pytest.mark.parametrize("n", [4, 32, 4096])
def test_closed_form_products_over_the_domain(n):
    """Over FrDomain's bit-reversed roots: prod_i (z - w_i) = z^n - 1, and
    the aligned chunk g of m = 2^l roots (the coset c H_m) has
    prod (z - w_i) = z^m - c^m = z^m - w_g, at every l and g (at 4096 on
    a sample of the chunks); so prod_i (w_i - z) = (-1)^n (z^n - 1)."""
    d = fr_poly.FrDomain(n, "cpu")
    w = d.roots_brp_ints
    rng = random.Random(n)
    z = rng.randrange(R)
    full = 1
    for x in w:
        full = full * (z - x) % R
    assert full == (pow(z, n, R) - 1) % R
    neg = 1
    for x in w:
        neg = neg * (x - z) % R
    assert neg == (-1) ** n * (pow(z, n, R) - 1) % R
    for level in range(d.levels + 1):
        m = 1 << level
        chunks = range(n // m) if n <= 32 else sorted(rng.sample(range(n // m), min(4, n // m)))
        for g in chunks:
            prod = 1
            for x in w[g * m : (g + 1) * m]:
                prod = prod * (z - x) % R
            assert prod == (pow(z, m, R) - w[g]) % R, (level, g)
            assert pow(w[g * m], m, R) == w[g]  # c^m with c the chunk's first root


@pytest.mark.parametrize("n", [4, 32, 4096])
def test_fraction_sum_gives_the_barycentric_y(n):
    """y = (1/n) sum_i e_i w_i prod_{j != i} (z - w_j) equals
    host/fft.barycentric_evaluate outside the domain, and the stored e_m at
    z = w_m, with no inversion but 1/n (at 4096 through the rendering of
    fr_evaluate's tree, on plain values)."""
    d = fr_poly.FrDomain(n, "cpu")
    w = d.roots_brp_ints
    rng = random.Random(n + 1)
    e = [rng.randrange(R) for _ in range(n)]
    m = rng.randrange(n)
    for z in (rng.randrange(R), w[m]):
        if n <= 32:
            total = 0
            for i in range(n):
                term = e[i] * w[i]
                for j in range(n):
                    if j != i:
                        term = term * (z - w[j]) % R
                total += term
            y = total * pow(n, -1, R) % R
        else:
            mont = [x * fr_poly.R_MONT % R for x in w]
            y = render_evaluate(e, _words_to_ints(d.z_table_host([z])[0]), mont,
                                pow(n, -1, R) * fr_poly.R_MONT % R, n, *_kernel_split(n))
        want = e[m] if z == w[m] else JFFT.barycentric_evaluate(e, z, n)
        assert y == want


@pytest.mark.parametrize("n", [4, 32])
def test_host_table_holds_the_powers_and_the_inverse(n):
    """z_table_host, all in Montgomery form: column l z^(2^l), the last
    column K = 1 / (z^n - 1), so that K prod_i (w_i - z) = (-1)^n: the
    product of batch_inv of the plain version's denominators times (-1)^n,
    in Montgomery form; 0 at a z in the domain."""
    d = fr_poly.FrDomain(n, "cpu")
    rng = random.Random(5 * n)
    zs = [rng.randrange(R) for _ in range(3)] + [d.roots_brp_ints[1]]
    denoms = FR.sub(d.roots_brp.expand(3, 16, n), d.z_consts(zs[:3])[0].expand(3, 16, n))
    inv = fr_poly.batch_inv(denoms)
    tab = d.z_table_host(zs)
    assert tab.dtype == np.int32 and tab.shape == (4, 8, d.levels + 1)
    assert torch.equal(d.z_table(zs), torch.from_numpy(tab))
    for b, z in enumerate(zs):
        row = _words_to_ints(tab[b])
        assert row[: d.levels] == [pow(z, 1 << lv, R) * fr_poly.R_MONT % R for lv in range(d.levels)]
        if b == 3:
            assert row[-1] == 0
            continue
        prod_inv = 1
        for v in FR.from_mont_host(inv[b]):
            prod_inv = prod_inv * v % R
        assert row[-1] == (-1) ** n * prod_inv * fr_poly.R_MONT % R
        assert row[-1] * pow(fr_poly.R_MONT, -1, R) * ((pow(z, n, R) - 1) % R) % R == 1


SPLITS = {4: [(4, 1), (2, 2), (2, 1), (1, 4)], 32: [(32, 1), (4, 8), (8, 2), (2, 4), (16, 2)]}


@pytest.mark.parametrize("n", [4, 32])
def test_kernel_schedules_equal_the_plain_versions(n):
    """The renderings of fr_evaluate and fr_quotient at several splits
    (threads, blocks; the kernels' own first) on plain evaluations and the
    host's table equal the CPU route of open_mont (y and q plain), the
    quotient also before any evaluation, and at z = w_m y = e_m."""
    d = fr_poly.FrDomain(n, "cpu")
    rng = random.Random(7 * n)
    e = [rng.randrange(R) for _ in range(n)]
    z = rng.randrange(R)
    roots = [x * fr_poly.R_MONT % R for x in d.roots_brp_ints]
    n_inv = pow(n, -1, R) * fr_poly.R_MONT % R
    plain = lb.as_limb_tensor(lb.ints_to_limbs(e, 16))[None]
    q_ref, y_ref = d.open_mont(plain, [z])
    want_y, want_q = lb.limbs_to_ints(y_ref[0])[0], lb.limbs_to_ints(q_ref[0])
    z_m, zn1_m = d.z_consts([z])
    ev_m = FR.to_mont(plain[0])
    assert want_y == FR.from_mont_host(d.evaluate_mont_plain(ev_m, z_m[0], zn1_m[0]))[0]
    assert want_q == lb.limbs_to_ints(d.quotient_mont_plain(ev_m, d.mont([want_y]), z_m[0]))
    tab = _words_to_ints(d.z_table_host([z])[0])
    assert _kernel_split(n) == SPLITS[n][0]
    for threads, blocks in SPLITS[n]:
        assert render_quotient(e, want_y, tab, roots, n, threads, blocks) == want_q
        assert render_evaluate(e, tab, roots, n_inv, n, threads, blocks) == want_y, (threads, blocks)
        m = rng.randrange(n)
        at_root = _words_to_ints(d.z_table_host([d.roots_brp_ints[m]])[0])
        assert render_evaluate(e, at_root, roots, n_inv, n, threads, blocks) == e[m]


def test_kernel_schedules_at_the_blob_domain():
    """At n = 4096 on the kernels' own split (8 blocks of 256 threads, 2
    elements a thread): the rendered route of open_mont on plain values
    equals the host's evaluation and quotient."""
    n = 4096
    d = fr_poly.FrDomain(n, "cpu")
    rng = random.Random(4096)
    e = [rng.randrange(R) for _ in range(n)]
    z = rng.randrange(R)
    assert _kernel_split(n) == (256, 8)
    roots = [x * fr_poly.R_MONT % R for x in d.roots_brp_ints]
    tab = _words_to_ints(d.z_table_host([z])[0])
    y = render_evaluate(e, tab, roots, pow(n, -1, R) * fr_poly.R_MONT % R, n, 256, 8)
    assert y == JFFT.barycentric_evaluate(e, z, n)
    assert render_quotient(e, y, tab, roots, n, 256, 8) == HostBackend(
        types.SimpleNamespace(n=n)).quotient(e, z, y)


def _root_ms(n: int) -> list:
    """Every m at n <= 32; at 4096, m = 0, 1, n - 1 and one seeded m."""
    return list(range(n)) if n <= 32 else [0, 1, n - 1, random.Random(n).randrange(2, n - 1)]


@pytest.mark.parametrize("n", [4, 32, 4096])
def test_in_domain_closed_forms(n):
    """At z = w_m: prod_{i != m} (z - w_i) = n / w_m, so K = w_m / n is its
    inverse; and the aligned chunk of s = 2^l bit-reversed roots that
    holds m has prod_{j != m} (z - w_j) = s z^s / z, at every level, while
    every other chunk keeps z^s - w_g; z^s and 1/z are roots."""
    d = fr_poly.FrDomain(n, "cpu")
    w = d.roots_brp_ints
    for m in _root_ms(n):
        z = w[m]
        full = 1
        for i, x in enumerate(w):
            if i != m:
                full = full * (z - x) % R
        assert full == n * pow(z, -1, R) % R
        assert full * (z * pow(n, -1, R)) % R == 1
        assert pow(z, -1, R) in d.root_index
        for level in range(d.levels + 1):
            size = 1 << level
            g = m >> level
            held = 1
            for j in range(g * size, (g + 1) * size):
                if j != m:
                    held = held * (z - w[j]) % R
            assert held == size * pow(z, size, R) * pow(z, -1, R) % R, (m, level)
            assert pow(z, size, R) in d.root_index
            other = g ^ 1 if size < n else None
            if other is not None and n <= 32:
                prod = 1
                for x in w[other * size:(other + 1) * size]:
                    prod = prod * (z - x) % R
                assert prod == (pow(z, size, R) - w[other]) % R


@pytest.mark.parametrize("n", [1, 4, 32])
def test_host_root_table_holds_powers_k_inverse_and_index(n):
    """root_table_host, int32 words [B, 8, levels + 3]: column l z^(2^l),
    then K = w_m / n, then 1/z, all in Montgomery form (value times
    R mod r), and m in word 0 of the last column; root_table is the same
    table on the domain's device."""
    d = fr_poly.FrDomain(n, "cpu")
    ms = list(range(n))
    tab = d.root_table_host(ms)
    assert tab.dtype == np.int32 and tab.shape == (n, 8, d.levels + 3)
    assert torch.equal(d.root_table(ms), torch.from_numpy(tab))
    for b, m in enumerate(ms):
        row, z = _words_to_ints(tab[b]), d.roots_brp_ints[m]
        assert row[: d.levels] == [pow(z, 1 << lv, R) * fr_poly.R_MONT % R for lv in range(d.levels)]
        assert row[d.levels] == z * pow(n, -1, R) * fr_poly.R_MONT % R
        assert row[d.levels + 1] == pow(z, -1, R) * fr_poly.R_MONT % R
        assert row[d.levels + 2] == m and tab[b, 0, -1] == m and not tab[b, 1:, -1].any()


IN_DOMAIN_SPLITS = {1: [(1, 1)], 4: [(4, 1), (2, 2), (1, 4)], 32: [(32, 1), (4, 8), (8, 2), (2, 4)]}


@pytest.mark.parametrize("n", [1, 4, 32])
def test_in_domain_schedule_equals_the_plain_version(n):
    """The rendering of fr_quotient_in_domain at several splits (its own
    first) on plain evaluations and the host's root table equals the plain
    version (`quotient_in_domain_mont_plain` on their Montgomery form) at
    every m, and the JAX host quotient there."""
    d = fr_poly.FrDomain(n, "cpu")
    rng = random.Random(11 * n)
    e = [rng.randrange(R) for _ in range(n)]
    roots = [x * fr_poly.R_MONT % R for x in d.roots_brp_ints]
    plain = lb.as_limb_tensor(lb.ints_to_limbs(e, 16))
    z_inv = d.mont([pow(w, -1, R) for w in d.roots_brp_ints]).T.reshape(n, 16, 1)
    want = d.quotient_in_domain_mont_plain(FR.to_mont(plain).expand(n, 16, n),
                                           torch.eye(n, dtype=torch.bool), z_inv)
    host = HostBackend(types.SimpleNamespace(n=n))
    assert IN_DOMAIN_SPLITS[n][0] == _kernel_split(n)
    for m in range(n):
        tab = _words_to_ints(d.root_table_host([m])[0])
        assert lb.limbs_to_ints(want[m]) == host.quotient(e, d.roots_brp_ints[m], e[m])
        for threads, blocks in IN_DOMAIN_SPLITS[n]:
            assert render_in_domain(e, tab, roots, n, threads, blocks) == lb.limbs_to_ints(want[m]), (
                m, threads, blocks)


def test_in_domain_schedule_at_the_blob_domain():
    """At n = 4096 on the kernel's own split (8 blocks of 256 threads, 2
    elements a thread, the blocks' sums across the cluster), m = 0, 1,
    n - 1 and a seeded m: the rendering equals the plain version."""
    n = 4096
    d = fr_poly.FrDomain(n, "cpu")
    rng = random.Random(4097)
    e = [rng.randrange(R) for _ in range(n)]
    roots = [x * fr_poly.R_MONT % R for x in d.roots_brp_ints]
    ms = _root_ms(n)
    assert _kernel_split(n) == (256, 8)
    want = d.quotient_in_domain(lb.as_limb_tensor(lb.ints_to_limbs(e, 16)), ms)
    for b, m in enumerate(ms):
        tab = _words_to_ints(d.root_table_host([m])[0])
        assert render_in_domain(e, tab, roots, n, 256, 8) == lb.limbs_to_ints(want[b]), m


def test_in_domain_route_is_one_call_on_the_plain_limbs(monkeypatch, case):
    """The card's route of a proof at a root of unity (FrDomain.quotient
    at z = w_m through dispatch.fr_quotient_in_domain), on the rendering
    of the kernel: one fr_quotient_in_domain call on the blob's plain
    limbs as they are, with its root table, no fr_to_mont and no layout
    conversion; q equals the CPU route and the JAX host quotient."""
    domain, host, blobs, _, _ = case
    roots_k = lb.to_u32_layout(domain.roots_brp)
    calls = []
    in_domain = _render_in_domain_kernel(domain, calls)

    def refuse(*args):
        raise AssertionError("the in-domain route converted the evaluations")

    plain = lb.as_limb_tensor(lb.ints_to_limbs(blobs[2], 16))
    m = 5
    table = domain.root_table([m])
    monkeypatch.setattr(kernels, "fr_quotient_in_domain", in_domain)
    for name in ("fr_to_mont", "fr_evaluate", "fr_quotient"):
        monkeypatch.setattr(kernels, name, refuse)
    monkeypatch.setattr(lb, "to_u32_layout", refuse)
    monkeypatch.setattr(lb, "to_u16_layout", refuse)
    q = dispatch.fr_quotient_in_domain(plain, [m], table, roots_k)
    monkeypatch.undo()
    assert [c[0] for c in calls] == ["fr_quotient_in_domain"]
    assert calls[0][1].data_ptr() == plain.data_ptr() and calls[0][2] is table
    assert q.shape == (16, domain.n)
    z = domain.roots_brp_ints[m]
    assert torch.equal(q, domain.quotient(plain, z, None))
    assert lb.limbs_to_ints(q) == host.quotient(blobs[2], z, blobs[2][m])


@pytest.mark.parametrize("lead", [(), (1,), (BLOBS,)])
def test_dispatch_routes_flatten_the_batch(monkeypatch, case, lead):
    """dispatch.fr_to_mont, fr_evaluate, fr_quotient and
    fr_quotient_in_domain on leading shapes (), (1,) and (B,), with one z
    for all blobs: fr_evaluate and fr_quotient (the renderings of their
    schedules) take the plain public limbs flattened to [B, 16, n] and the
    table of each blob's z, and the results equal the plain versions; the
    in-domain route (the rendering of fr_quotient_in_domain) takes the
    plain limbs too, and the table that holds each blob's index."""
    domain, _, blobs, evals_m, zs = case
    monkeypatch.setattr(domain, "roots_k", lb.to_u32_layout(domain.roots_brp))
    monkeypatch.setattr(domain, "n_inv_k", lb.to_u32_layout(domain.n_inv))

    evaluate, quotient, calls = _render_kernels(domain)
    in_domain = _render_in_domain_kernel(domain, calls)
    monkeypatch.setattr(kernels, "fr_to_mont", lambda a: lb.to_u32_layout(FR.to_mont(lb.to_u16_layout(a))))
    monkeypatch.setattr(kernels, "fr_evaluate", evaluate)
    monkeypatch.setattr(kernels, "fr_quotient", quotient)
    monkeypatch.setattr(kernels, "fr_quotient_in_domain", in_domain)
    k = int(np.prod(lead, dtype=np.int64))
    ev = evals_m[:k].reshape(lead + (16, domain.n))
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs[:k]])).reshape(ev.shape)
    assert torch.equal(dispatch.fr_to_mont(plain), ev)
    z_m, zn1_m = domain.z_consts(zs[:1])
    z_m, zn1_m = z_m[0].expand(lead + (16, 1)), zn1_m[0].expand(lead + (16, 1))
    want_y = FR.from_mont(domain.evaluate_mont_plain(ev, z_m, zn1_m))
    table = domain.z_table(zs[:1] * k)
    y = dispatch.fr_evaluate(plain, table, domain.roots_k, domain.n_inv_k)
    assert y.shape == lead + (16, 1) and torch.equal(y, want_y)
    q = dispatch.fr_quotient(plain, y, table, domain.roots_k)
    assert torch.equal(q, domain.quotient_mont_plain(ev, FR.to_mont(y), z_m))
    assert [c[0] for c in calls] == ["fr_evaluate", "fr_quotient"]
    assert all(c[1].shape == (k, 16, domain.n) for c in calls)
    ms = [(5 * b + 1) % domain.n for b in range(k)]
    onehot = torch.stack([torch.arange(domain.n) == m for m in ms]).reshape(lead + (domain.n,))
    z_inv = torch.stack([domain.mont([pow(domain.roots_brp_ints[m], R - 2, R)]) for m in ms])
    z_inv = z_inv.reshape(lead + (16, 1))
    q_in = dispatch.fr_quotient_in_domain(plain, ms, domain.root_table(ms), domain.roots_k)
    assert calls[-1][0] == "fr_quotient_in_domain" and calls[-1][1].shape == (k, 16, domain.n)
    assert calls[-1][2][:, 0, -1].tolist() == ms  # each blob's index, in the table
    assert q_in.shape == lead + (16, domain.n)
    assert torch.equal(q_in, domain.quotient_in_domain_mont_plain(ev, onehot, z_inv))


@pytest.mark.parametrize("quotient", [True, False])
def test_fr_open_keeps_the_kernel_layout(monkeypatch, case, quotient):
    """dispatch.fr_open, the card's route of FrDomain.open_mont, on the
    renderings of the kernels: fr_evaluate and fr_quotient take the plain
    public limbs as they are (no conversion of form or layout, no
    fr_to_mont) and the host's table, which they leave as it is, and q and
    y (both plain) equal the CPU domain's open_mont (the plain
    versions)."""
    domain, _, blobs, _, zs = case
    roots_k, n_inv_k = lb.to_u32_layout(domain.roots_brp), lb.to_u32_layout(domain.n_inv)
    evaluate, quotient_k, calls = _render_kernels(domain)

    def refuse(*args):
        raise AssertionError("fr_open converted the evaluations")

    monkeypatch.setattr(kernels, "fr_to_mont", refuse)
    monkeypatch.setattr(kernels, "fr_evaluate", evaluate)
    monkeypatch.setattr(kernels, "fr_quotient", quotient_k)
    plain = lb.as_limb_tensor(np.stack([lb.ints_to_limbs(b, 16) for b in blobs]))
    table = torch.from_numpy(domain.z_table_host(zs))
    assert table.shape == (BLOBS, kernels.FR_NL, domain.levels + 1)
    q, y = dispatch.fr_open(plain, table, roots_k, n_inv_k, quotient)
    assert torch.equal(table, torch.from_numpy(domain.z_table_host(zs)))
    want_q, want_y = domain.open_mont(plain, zs, quotient)
    assert torch.equal(y, want_y) and y.shape == (BLOBS, 16, 1)
    assert (q is None and want_q is None) if not quotient else torch.equal(q, want_q)
    assert [c[0] for c in calls] == ["fr_evaluate", "fr_quotient"][: 1 + quotient]
    assert all(c[1] is plain and c[2] is table for c in calls)


def test_quotient_route_needs_no_evaluation_first(monkeypatch, case):
    """FrDomain.quotient's card route, dispatch.fr_quotient on one blob's
    plain limbs, the host int y and a fresh table of its z, on the
    rendering of fr_quotient with fr_evaluate refused: the table alone
    carries what the quotient needs, and q equals the CPU route and the
    JAX host quotient."""
    domain, host, blobs, _, zs = case
    evaluate, quotient_k, calls = _render_kernels(domain)

    def refuse(*args):
        raise AssertionError("the quotient's route ran an evaluation")

    monkeypatch.setattr(kernels, "fr_evaluate", refuse)
    monkeypatch.setattr(kernels, "fr_quotient", quotient_k)
    plain = lb.as_limb_tensor(lb.ints_to_limbs(blobs[1], 16))
    y = JFFT.barycentric_evaluate(blobs[1], zs[1], domain.n)
    q = dispatch.fr_quotient(plain, domain.limbs([y]), domain.z_table([zs[1]]),
                             lb.to_u32_layout(domain.roots_brp))
    assert [c[0] for c in calls] == ["fr_quotient"] and q.shape == (16, domain.n)
    assert torch.equal(q, domain.quotient(plain, zs[1], y))
    assert lb.limbs_to_ints(q) == host.quotient(blobs[1], zs[1], y)


def test_smoke_counts_the_fr_kernels_work():
    """An Fr product is 264 IMADs, a squaring 208 and a reduction alone
    136; the smoke's inversion at its cheapest window costs no more than
    fr::inv's fixed 4-bit window (252 squarings, 73 products) and no less
    than the 254 squarings of r - 2. Each kernel is charged the fewest
    products of its function, the chunks' denominators in closed form from
    L = log2 n squarings: the evaluation 2 n + 1 a blob (a tree of
    fraction sums with known denominators, then z N, (z^n - 1) sum e and
    1 / n) and no inversion, the quotient 3 n - 2 (a tree of inverses down
    from 1 / (z^n - 1), then the n quotients) and its one inversion, the
    in-domain quotient 4 n - 1 + L and no inversion or squaring (the same
    tree from K = w_m / n, L products for the chunk that holds m, the n
    quotients, q_m on them; z's powers are roots); the evaluation reads its
    evaluations (32 bytes an element, whatever layout the kernel reads),
    the roots, the z table (L + 1 values a blob) and 1/n once and writes
    y, the quotient reads the evaluations, y, the roots and the table and
    writes its quotients; so both bounds are by operations at 1, 6 and 64
    blobs."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (P.IMAD_PER_FR_MUL, P.IMAD_PER_FR_SQR, P.IMAD_PER_FR_REDC) == (264, 208, 136)
    assert smoke.IMAD_PER_FR_MUL is P.IMAD_PER_FR_MUL and smoke.IMAD_PER_FR_SQR is P.IMAD_PER_FR_SQR
    inv = smoke.fr_inv_imads()
    assert 254 * 208 <= inv <= 252 * 208 + 73 * 264
    n, b, levels = 4096, 6, 12
    nbytes, imads = smoke.fr_kernel_work("fr_quotient", n, b)
    assert nbytes == 2 * b * n * 32 + n * 32 + b * (levels + 1) * 32 + b * 32
    assert imads == b * ((3 * n - 2) * 264 + levels * 208 + inv)
    assert smoke.fr_kernel_work("fr_evaluate", n, b) == (
        b * n * 32 + n * 32 + b * (levels + 1) * 32 + b * 32 + 32, b * ((2 * n + 1) * 264 + levels * 208))
    for blobs in (1, 6, 64):
        for name in ("fr_evaluate", "fr_quotient"):
            assert smoke.bound(*smoke.fr_kernel_work(name, n, blobs))["bound_by"] == "operations"
    assert smoke.bound(*smoke.fr_kernel_work("fr_evaluate", n, 1))["bound_ms"] == pytest.approx(
        ((2 * n + 1) * 264 + levels * 208) / P.IMAD_PER_S * 1e3)
    in_domain = smoke.fr_kernel_work("fr_quotient_in_domain", n, b)
    assert in_domain == (2 * b * n * 32 + n * 32 + b * ((levels + 2) * 32 + 4),
                         b * (4 * n - 1 + levels) * 264)
    assert smoke.bound(*in_domain)["bound_by"] == "operations"
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
