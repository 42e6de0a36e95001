"""The level programs of the pairing kernels (`ops/pairing_levels.py`),
run on the CPU by the emulator exactly as `csrc/pairing.cu` runs them.

- one doubling and one addition step of the Miller loop's program equal
  the plain version's step (`pairing_ops._dbl_step` / `_add_step`, then
  `fp12_sqr` and the product by the sparse line) on random values;
- the affine subroutine gives the affine points, T = (xq, yq, 1), f = 1;
- the final exponentiation's subroutines equal the host tower's
  products, cyclotomic squares, Frobenius maps and easy part;
- whole checks through both programs (a true one at B = 2, a false one
  at B = 3 with members at infinity): FE^3 equals the host pairing cubed;
- the program counts (levels per step, 56 products at most a level), the
  encoding as the kernel reads it, and the kernel's constants;
- the kernel's word arithmetic where the emulator takes exact integers:
  a linear entry's lazy 64-bit sums and reduction (`levels.cuh`
  `lin_phase`, mirrored word for word) at the largest coefficients and
  values and on every entry of both programs, and the binary inverse
  (`binv::inverse`, built from `levels.cuh` with the host compiler) on
  edge inputs.

No plain pairing check runs here (seconds of small torch ops on the CPU);
the card holds the kernels against the plain versions limb for limb.
Tolerance: none; every value is an exact field element."""

import os
import random
import re
import shutil
import subprocess

import pytest
import torch

from lambdaworks_kzg_tpu_torch.constants import P
from lambdaworks_kzg_tpu_torch.host import curve as HC, field as HF, pairing as HP
from lambdaworks_kzg_tpu_torch.ops import fp2_ops as F2
from lambdaworks_kzg_tpu_torch.ops import pairing_levels as PL
from lambdaworks_kzg_tpu_torch.ops import pairing_ops as PO, tower_ops as T
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "lambdaworks_kzg_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def progs():
    return PL.programs()


def _flat(a):
    return [x for half in a for pair in half for x in pair]


def _unflat(v):
    return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3))
                 for i in range(2))


def _set(mem, lay, prefix, values):
    for i, v in enumerate(values):
        mem[lay[f"{prefix}{i}"]] = v % P


def _get(mem, lay, prefix, n):
    return [mem[lay[f"{prefix}{i}"]] for i in range(n)]


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


def _fp12_t(v):
    return T.fp12_from_host([_unflat(v)], "cpu")


def _fp2_t(v):
    return F2.from_host([v], "cpu")


def _fp_t(x):
    return torch.tensor(FP.to_mont_host([x]), dtype=torch.int64).reshape(FP.L, 1)


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_step_equals_the_plain_step(progs, step):
    prog = progs[0]
    lay = prog.state
    rng = random.Random(7 if step == "dbl" else 8)
    f, tx, ty, tz, xq, yq = _rand(rng, 12), _rand(rng, 2), _rand(rng, 2), _rand(rng, 2), \
        _rand(rng, 2), _rand(rng, 2)
    xp, yp = rng.randrange(P), rng.randrange(P)
    mem = [None] * prog.slots
    _set(mem, lay, "f", f)
    for name, v in (("tx", tx), ("ty", ty), ("tz", tz), ("xq", xq), ("yq", yq)):
        _set(mem, lay, name, v)
    mem[lay["xp"]], mem[lay["yp"]] = xp, yp
    PL.run_sub(prog, step, mem)

    pt = (_fp2_t(tuple(tx)), _fp2_t(tuple(ty)), _fp2_t(tuple(tz)))
    f_t = _fp12_t(f)
    if step == "dbl":
        f_t = T.fp12_sqr(f_t)
        pt, line = PO._dbl_step(pt, _fp_t(xp), _fp_t(yp))
    else:
        pt, line = PO._add_step(pt, (_fp2_t(tuple(xq)), _fp2_t(tuple(yq))), _fp_t(xp), _fp_t(yp))
    f_t = T.fp12_mul(f_t, PO._sparse_to_fp12(line))
    assert _get(mem, lay, "f", 12) == _flat(T.fp12_to_host(f_t)[0])
    for name, c in zip(("tx", "ty", "tz"), pt):
        assert tuple(_get(mem, lay, name, 2)) == F2.to_host(c)[0]


def test_miller_affine_subroutine(progs):
    prog = progs[0]
    lay = prog.state
    rng = random.Random(9)
    p1 = HC.point_scalar_mul(HC.G1_GENERATOR, 77)
    q2 = HC.g2_scalar_mul(HC.G2_GENERATOR, 91)
    lam, mu = rng.randrange(2, P), (rng.randrange(P), rng.randrange(P))
    pj = (p1[0] * lam * lam % P, p1[1] * pow(lam, 3, P) % P, p1[2] * lam % P)
    qj = (HF.fp2_mul(q2[0], HF.fp2_sqr(mu)), HF.fp2_mul(q2[1], HF.fp2_mul(HF.fp2_sqr(mu), mu)),
          HF.fp2_mul(q2[2], mu))
    mem = [None] * prog.slots
    for name, v in zip(PL.MILLER_INPUTS, [pj[0], pj[1], pj[2]] + [c for x in qj for c in x]):
        mem[lay[name]] = v
    mem[lay["one"]] = 1
    PL.run_sub(prog, "affine", mem)
    xp, yp = HC.to_affine(p1)
    xq, yq = HC.g2_to_affine(q2)
    assert (mem[lay["xp"]], mem[lay["yp"]]) == (xp, yp)
    assert tuple(_get(mem, lay, "xq", 2)) == xq and tuple(_get(mem, lay, "yq", 2)) == yq
    assert tuple(_get(mem, lay, "tx", 2)) == xq and tuple(_get(mem, lay, "ty", 2)) == yq
    assert _get(mem, lay, "tz", 2) == [1, 0]
    assert _get(mem, lay, "f", 12) == [1] + [0] * 11


def _cyclotomic(rng):
    f = _unflat(_rand(rng, 12))
    t = HF.fp12_mul(HF.fp12_conj(f), HF.fp12_inv(f))
    return HF.fp12_mul(HF.fp12_frobenius_n(t, 2), t)


def test_final_exp_subroutines(progs):
    prog = progs[1]
    lay = prog.state
    rng = random.Random(10)
    mem = [None] * prog.slots
    for k in range(6):
        for i in range(2):
            mem[lay[f"gamma{k}_{i}"]] = HF.FROBENIUS_GAMMA[k][i]
    mem[lay["one"]] = 1
    acc, fin = _unflat(_rand(rng, 12)), _unflat(_rand(rng, 12))
    _set(mem, lay, "acc", _flat(acc))
    _set(mem, lay, "fin", _flat(fin))
    PL.run_sub(prog, "mulacc", mem)
    acc = HF.fp12_mul(acc, fin)
    assert _get(mem, lay, "acc", 12) == _flat(acc)
    PL.run_sub(prog, "easy", mem)
    t = HF.fp12_mul(HF.fp12_conj(acc), HF.fp12_inv(acc))
    m = HF.fp12_mul(HF.fp12_frobenius_n(t, 2), t)
    assert _get(mem, lay, "m", 12) == _flat(m) and _get(mem, lay, "base", 12) == _flat(m)
    PL.run_sub(prog, "cyc0", mem)
    r = HF.fp12_sqr(m)
    assert _get(mem, lay, "r", 12) == _flat(r)
    PL.run_sub(prog, "cyc", mem)
    r = HF.fp12_sqr(r)
    assert _get(mem, lay, "r", 12) == _flat(r)
    PL.run_sub(prog, "mulb", mem)
    r = HF.fp12_mul(r, m)
    assert _get(mem, lay, "r", 12) == _flat(r)
    PL.run_sub(prog, "g2", mem)
    bm = HF.fp12_conj(r)
    assert _get(mem, lay, "bm", 12) == _flat(bm) == _get(mem, lay, "base", 12)
    r2 = _cyclotomic(rng)
    _set(mem, lay, "r", _flat(r2))
    PL.run_sub(prog, "g3", mem)
    c = HF.fp12_mul(HF.fp12_conj(r2), HF.fp12_frobenius(bm))
    assert _get(mem, lay, "c", 12) == _flat(c) == _get(mem, lay, "base", 12)
    PL.run_sub(prog, "g1", mem)
    assert _get(mem, lay, "base", 12) == _flat(HF.fp12_conj(r2))
    PL.run_sub(prog, "g5", mem)
    g = HF.fp12_mul(HF.fp12_mul(HF.fp12_conj(r2), HF.fp12_frobenius_n(c, 2)), HF.fp12_conj(c))
    assert _get(mem, lay, "out", 12) == _flat(HF.fp12_mul(g, HF.fp12_mul(HF.fp12_sqr(m), m)))


def test_plain_cyclotomic_square_equals_the_program(progs):
    """One cyclotomic square through the program and through the plain
    tower's Granger-Scott squaring."""
    prog = progs[1]
    lay = prog.state
    g = _cyclotomic(random.Random(11))
    mem = [None] * prog.slots
    _set(mem, lay, "r", _flat(g))
    PL.run_sub(prog, "cyc", mem)
    plain = T.fp12_cyc_sqr(T.fp12_from_host([g], "cpu"))
    assert _get(mem, lay, "r", 12) == _flat(T.fp12_to_host(plain)[0])


def _jac(p1, lam):
    return (p1[0] * lam * lam % P, p1[1] * pow(lam, 3, P) % P, p1[2] * lam % P)


def test_checks_through_both_programs(progs):
    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pa, qb = HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29)
    neg_pab = HC.point_neg(HC.point_scalar_mul(G, 13 * 29))
    cases = (([(neg_pab, G2), (pa, qb)], True),
             ([(neg_pab, G2), (pa, HC.G2_INFINITY), (HC.INFINITY, qb)], False))
    rng = random.Random(12)
    for pairs, verdict in cases:
        fs = []
        for p1, q2 in pairs:
            pj = p1 if HC.is_infinity(p1) else _jac(p1, rng.randrange(2, P))
            fs.append(PL.emulate_miller_loop(progs[0], pj, q2))
        fe, ok = PL.emulate_final_exp(progs[1], fs)
        host = HP.pairing_batch(pairs)
        assert _unflat(fe) == HF.fp12_mul(HF.fp12_sqr(host), host)
        assert ok is verdict
    assert fs[1] == fs[2] == [1] + [0] * 11  # the pairs with a member at infinity


def test_program_shape(progs):
    miller, fe = progs
    subs = {s.name: s for s in miller.subs + fe.subs}
    assert subs["dbl"].levels == 3 and subs["add"].levels == 4
    assert subs["cyc"].levels == 1 and subs["cyc"].waves == 1 and subs["cyc"].products == 30
    assert subs["mulb"].levels == 1 and subs["mulb"].products == 54
    assert subs["affine"].levels <= 6 and subs["easy"].levels <= 12
    for s in miller.subs + fe.subs:
        for ph in s.phases:
            limit = {PL.MUL: PL.GROUPS, PL.LIN: PL.THREADS, PL.INV: PL.INV_MAX}[ph.kind]
            assert len(ph.entries) <= limit
    assert [s.name for s in miller.subs] == list(PL.MILLER_SUBS)
    assert [s.name for s in fe.subs] == list(PL.FE_SUBS)
    assert PL.count(miller, PL.miller_calls())["levels"] == sum(
        subs[n].levels for n in PL.miller_calls())
    for prog in (miller, fe):  # the slots and the program's copy in one block's shared memory
        assert (prog.slots * PL.WORDS + len(prog.words)) * 4 <= 232448


def _decode(words, n_subs):
    """The encoded program read as the kernel reads it."""
    u = [w & 0xFFFFFFFF for w in words]
    table = u[PL.H_TABLE]
    subs = []
    for s in range(n_subs):
        first, count = u[PL.H_SUBS + 2 * s], u[PL.H_SUBS + 2 * s + 1]
        phases = []
        for i in range(first, first + count):
            kind, n, off, stride = u[table + 4 * i : table + 4 * i + 4]
            if kind == PL.MUL:
                ents = [(w & 1023, (w >> 10) & 1023, w >> 20) for w in u[off : off + n]]
            elif kind == PL.INV:
                ents = [(w & 1023, w >> 10) for w in u[off : off + n]]
            else:
                ents = []
                for t in range(n):
                    h = u[off + t * stride]
                    nt = h >> 16
                    ts = []
                    for w in u[off + t * stride + 1 : off + t * stride + 1 + nt]:
                        k = w >> 16
                        ts.append((w & 0xFFFF, k - (1 << 16) if k >= 1 << 15 else k))
                    ents.append((h & 0xFFFF, ts))
            phases.append((kind, ents))
        subs.append(phases)
    return subs


def test_encoding_round_trip(progs):
    for prog in progs:
        assert prog.words[PL.H_SLOTS] == prog.slots
        assert prog.words[PL.H_IO : PL.H_IO + len(prog.io)] == prog.io
        assert _decode(prog.words, len(prog.subs)) == [[(p.kind, p.entries) for p in s.phases] for s in prog.subs]


def test_kernel_constants_match_the_programs():
    levels = open(os.path.join(CSRC, "levels.cuh")).read()
    pairing = open(os.path.join(CSRC, "pairing.cu")).read()
    header = (f"kHeaderSlots = {PL.H_SLOTS}, kHeaderTable = {PL.H_TABLE}, "
              f"kHeaderSubs = {PL.H_SUBS}, kHeaderIo = {PL.H_IO}")
    assert header in levels
    assert f"kMul = {PL.MUL}, kLin = {PL.LIN}, kInv = {PL.INV}" in levels
    assert f"constexpr int kThreads = {PL.THREADS};" in levels
    for name, value in (("kR3", pow(1 << 384, 3, P)), ("k2P", 2 * P)):
        words = [int(w, 16) for w in re.search(name + r" = \{\{([^}]*)\}\}", levels).group(1)
                 .replace("u", "").split(",")]
        assert sum(w << (32 * i) for i, w in enumerate(words)) == value, name
    assert f"kInvPTop = 1.0 / {(P >> 352) + 1}.0;" in levels
    miller = re.search(r"enum MillerSub : int \{([^}]*)\}", pairing).group(1)
    assert [x.split("=")[0].strip() for x in miller.split(",")] == [
        "k" + n.capitalize() for n in PL.MILLER_SUBS]
    fe = re.search(r"enum FeSub : int \{([^}]*)\}", pairing).group(1)
    assert [x.split("=")[0].strip().lower() for x in fe.split(",")] == [
        "k" + n for n in PL.FE_SUBS]
    assert "kMillerOne = 9, kMillerOut = 10" in pairing
    assert "kFeAcc = 0, kFeFin = 12, kFeGamma = 24, kFeOne = 36, kFeOut = 37" in pairing


# -- the kernel's word arithmetic ---------------------------------------------

M32 = (1 << 32) - 1


def _words(x):
    return [(x >> (32 * w)) & M32 for w in range(12)]


def _lin_phase(terms):
    """levels.cuh lin_phase on [(value < p, coef)], word for word, with its
    bounds asserted; returns the slot's value."""
    pw = _words(P)
    acc, neg = [0] * 12, 0
    for x, k in terms:
        a, flip = abs(k), M32 if k < 0 else 0
        for w, xw in enumerate(_words(x)):
            acc[w] += a * (xw ^ flip)
        neg += a if k < 0 else 0
    assert max(acc) < 1 << 64 and neg < 1 << 32
    v, c = [0] * 13, neg
    for w in range(12):
        x = acc[w] + neg * pw[w] + c
        assert x < 1 << 64
        v[w], c = x & M32, x >> 32
    v[12] = ((c & M32) - neg) & M32
    top = v[12] << 32 | v[11]
    q = int(float(top) * (1.0 / 436277739.0))  # __double2uint_rz
    assert q < 1 << 32
    q = q - 1 if q else 0
    r, b = [0] * 12, 0
    for w in range(12):
        x = v[w] - q * pw[w] + b
        assert -(1 << 63) <= x < 1 << 63
        r[w], b = x & M32, x >> 32
    big = sum(w << (32 * i) for i, w in enumerate(v))
    assert big == sum(k * x for x, k in terms) + neg * P  # V = sum c_i x_i + n p
    # the word above the twelve goes to zero, q <= floor(V / p), V - q p < 4p
    assert v[12] + b == 0 and 0 <= big - q * P < 4 * P
    out = sum(w << (32 * i) for i, w in enumerate(r))
    out = out - 2 * P if out >= 2 * P else out
    return out - P if out >= P else out


@pytest.mark.parametrize("case", ["positive", "negative", "mixed", "zeros"])
def test_lin_phase_word_arithmetic_at_the_limits(case):
    """Entries of LIN_CAP terms whose |c_i| sum to just below
    COEF_SUM_MAX, each below COEF_MAX, on the largest values."""
    rng = random.Random(13)
    n = PL.LIN_CAP
    budget = PL.COEF_SUM_MAX - 1
    ks = [min(PL.COEF_MAX - 1, budget // n + (1 if i < budget % n else 0)) for i in range(n)]
    ks[-1] += budget - sum(ks)
    assert sum(ks) < PL.COEF_SUM_MAX and max(ks) < PL.COEF_MAX
    sign = {"positive": [1] * n, "negative": [-1] * n, "zeros": [-1] * n,
            "mixed": [rng.choice((1, -1)) for _ in range(n)]}[case]
    for xs in ([P - 1] * n, [0] * n if case == "zeros" else [rng.randrange(P) for _ in range(n)],
               [rng.choice((0, 1, P - 1, P - 2)) for _ in range(n)]):
        terms = [(x, s * k) for x, s, k in zip(xs, sign, ks)]
        assert _lin_phase(terms) == sum(k * x for x, k in terms) % P
    for terms in ([(P - 1, -1)], [(P - 1, 1)], [(0, -1)], [(1, -(PL.COEF_MAX - 1))]):
        assert _lin_phase(terms) == sum(k * x for x, k in terms) % P


def test_lin_phase_word_arithmetic_on_the_programs(progs):
    """Every distinct linear entry of both programs, on p - 1 in every
    term and on random values."""
    rng = random.Random(14)
    coefs = {tuple(k for _, k in ts) for prog in progs for s in prog.subs for ph in s.phases
             if ph.kind == PL.LIN for _, ts in ph.entries}
    for ks in sorted(coefs):
        for xs in ([P - 1] * len(ks), [rng.randrange(P) for _ in ks]):
            terms = list(zip(xs, ks))
            assert _lin_phase(terms) == sum(k * x for x, k in terms) % P


_BINV_MAIN = r"""
#include <cstdio>
#include <cstring>
#include "levels.cuh"

static void read_hex(const char* s, uint32_t (&x)[binv::N]) {
  std::memset(x, 0, sizeof(x));
  const int n = (int)std::strlen(s);
  for (int i = 0; i < n; ++i) {
    const int d = s[n - 1 - i] <= '9' ? s[n - 1 - i] - '0' : s[n - 1 - i] - 'a' + 10;
    x[i / 8] |= (uint32_t)d << (4 * (i % 8));
  }
}

int main() {
  char line[256];
  uint32_t p[binv::N], a[binv::N], r[binv::N];
  if (!std::fgets(line, sizeof(line), stdin)) return 1;
  line[std::strcspn(line, "\n")] = 0;
  read_hex(line, p);
  while (std::fgets(line, sizeof(line), stdin)) {
    line[std::strcspn(line, "\n")] = 0;
    read_hex(line, a);
    binv::inverse(a, p, r);
    for (int k = binv::N - 1; k >= 0; --k) std::printf("%08x", r[k]);
    std::printf("\n");
  }
  return 0;
}
"""


def test_binary_inverse_builds_on_the_host_and_inverts(tmp_path):
    """binv::inverse from levels.cuh, compiled by the host's C++ compiler,
    against Python's inverse on 0, 1, 2, p - 1, p - 2, (p + 1) / 2, every
    power of two below p and random values."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src, exe = tmp_path / "binv.cc", tmp_path / "binv"
    src.write_text(_BINV_MAIN)
    subprocess.run([cxx, "-std=c++17", "-O1", "-D__host__=", "-D__device__=",
                    "-D__forceinline__=inline", "-I", CSRC, str(src), "-o", str(exe)],
                   check=True, capture_output=True)
    rng = random.Random(15)
    xs = [0, 1, 2, P - 1, P - 2, (P + 1) // 2] + [1 << k for k in range(P.bit_length())]
    xs += [rng.randrange(P) for _ in range(64)]
    run = subprocess.run([str(exe)], input="\n".join(f"{x:x}" for x in [P] + xs) + "\n",
                         capture_output=True, text=True, check=True)
    got = [int(line, 16) for line in run.stdout.split()]
    assert got == [pow(x, -1, P) if x else 0 for x in xs]
