"""Evaluation-form polynomials over Fr on limb tensors.

The port of the JAX package's `ops/fr_poly.py`: barycentric evaluation
and the KZG quotient on the bit-reversed roots-of-unity domain. Values
are Montgomery Fr limbs [..., 16, n] (`field_ops.FR`) on the domain's
device, with any leading batch dimensions; quotients come out as plain
limbs, the form the fixed-base MSM takes. The JAX package jits its three
programs once per domain size (`_eval_kernel`, `_quotient_kernel`,
`_quotient_in_domain_kernel`); here each is one Hopper kernel launch per
batch of blobs on a CUDA tensor (`csrc/fr_poly.cu` through
`ops/dispatch.py`: `fr_evaluate`, `fr_quotient`,
`fr_quotient_in_domain`), with no fallback, and its plain PyTorch
version (`evaluate_mont_plain`, `quotient_mont_plain`,
`quotient_in_domain_mont_plain`) on a CPU tensor. The three kernels take
the plain public limbs and each z as a row of a table made on the host
in one transfer: `FrDomain.z_table` (its powers z^(2^l) and the
quotient's 1 / (z^n - 1)) outside the domain, `FrDomain.root_table`
(its powers, w_m / n, 1/z and m) at z = w_m. So `FrDomain.open_mont`
runs a batch's evaluation and quotient in two launches and
`FrDomain.quotient_in_domain` in one, with no conversion of form or
layout, and y and q come out plain; `FrDomain.evaluate` and
`FrDomain.quotient` take a blob's plain limbs through the same kernels.
`FrDomain.to_mont` runs `fr_to_mont`, which no path needs any more. The
plain versions also run on the card when called by name, as the
reference the kernels are held against. `host/fft.py` and the host
quotient are the oracles.
"""

import functools

import numpy as np
import torch

from ..constants import R
from ..host import fft
from . import dispatch, limbs as lb
from .field_ops import FR

R_MONT = (1 << 256) % R  # R mod r, the Montgomery factor of FR


def _host_inverses(values) -> list:
    """Inverses mod r of host ints, 0 -> 0, by Montgomery's trick: one
    modular inversion for all of them."""
    values = [v % R for v in values]
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        if v:
            acc = acc * v % R
    inv, out = pow(acc, -1, R), [0] * len(values)
    for i in reversed(range(len(values))):
        if values[i]:
            out[i] = inv * prefix[i] % R
            inv = inv * values[i] % R
    return out


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverses of x [..., 16, B] (Montgomery, none zero, B a power of
    two) through a product tree: 2 log2(B) levels of products and one
    Fermat inversion per leading index (JAX `batch_inv`)."""
    if x.shape[-1] & (x.shape[-1] - 1):
        raise ValueError("batch_inv takes a power-of-two lane count")
    levels = [x]
    while levels[-1].shape[-1] > 1:
        cur = levels[-1]
        half = cur.shape[-1] // 2
        levels.append(FR.mul(cur[..., :half], cur[..., half:]))
    inv = FR.inv(levels[-1])
    for below in reversed(levels[:-1]):
        half = below.shape[-1] // 2
        inv = torch.cat([FR.mul(inv, below[..., half:]), FR.mul(inv, below[..., :half])], dim=-1)
    return inv


def _sum_tree(x: torch.Tensor) -> torch.Tensor:
    """Pairwise tree sum over the lanes: [..., 16, B] -> [..., 16, 1]."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = FR.add(x[..., :half], x[..., half:])
    return x


def _masked_pick(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The one lane where onehot [..., n] is True: [..., 16, n] -> [..., 16, 1]."""
    return torch.where(onehot.unsqueeze(-2), x, 0).sum(dim=-1, keepdim=True)


class FrDomain:
    """The domain of size n = 2^levels on one device: the roots in
    bit-reversed order (`roots_brp`, Montgomery [16, n], and
    `roots_brp_ints` with `root_index` on the host, beside `roots_ints` in
    natural order, `roots_brp_le` as the native tier's bytes) and 1/n; on
    a card also both in the kernel layout (`roots_k` [8, n], `n_inv_k`
    [8, 1]), resident for the kernels. On the card unless "cpu" is asked
    for; raises where CUDA is absent."""

    def __init__(self, n: int, device="cuda"):
        if n < 1 or n & (n - 1):
            raise ValueError("the domain size must be a power of two")
        self.n = n
        self.levels = n.bit_length() - 1
        self.device = dispatch.resolve_device(device)
        self.roots_ints = fft.fr_roots_of_unity(n)  # natural order: w^k at k
        self.roots_brp_ints = fft.bit_reversal_permutation(self.roots_ints)
        self.root_index = {w: i for i, w in enumerate(self.roots_brp_ints)}
        self.roots_brp = self.mont(self.roots_brp_ints)
        self.n_inv = self.mont([pow(n, R - 2, R)])
        self.roots_k = self.n_inv_k = None
        if self.device.type == "cuda":
            self.roots_k, self.n_inv_k = lb.to_u32_layout(self.roots_brp), lb.to_u32_layout(self.n_inv)

    @functools.cached_property
    def roots_brp_le(self) -> bytes:
        """The roots in bit-reversed order as n 32-byte little-endian
        words, the domain `native.blob_eval` takes."""
        return b"".join(w.to_bytes(32, "little") for w in self.roots_brp_ints)

    def mont(self, values) -> torch.Tensor:
        """Host ints -> Montgomery limbs [16, len(values)] on the device."""
        return lb.as_limb_tensor(FR.to_mont_host([v % R for v in values]), self.device)

    def to_mont(self, plain: torch.Tensor) -> torch.Tensor:
        """Plain limbs [..., 16, n] -> Montgomery: one `fr_to_mont` launch on
        a CUDA tensor, `FR.to_mont` on the CPU."""
        if plain.is_cuda:
            return dispatch.fr_to_mont(plain)
        return FR.to_mont(plain)

    def z_consts(self, zs):
        """Host zs -> (z, z^n - 1), Montgomery [B, 16, 1] each, in one
        transfer (the plain versions' arguments)."""
        values = [v % R for v in list(zs) + [pow(z, self.n, R) - 1 for z in zs]]
        pair = self.mont(values).T.reshape(2, len(zs), 16, 1)
        return pair[0], pair[1]

    def limbs(self, values) -> torch.Tensor:
        """Host ints -> plain limbs [16, len(values)] on the device."""
        return lb.as_limb_tensor(lb.ints_to_limbs([v % R for v in values], 16), self.device)

    def z_table_host(self, zs) -> np.ndarray:
        """Host zs -> the table of each z that `fr_evaluate` and
        `fr_quotient` read, int32 words [B, 8, levels + 1] (the kernel
        layout), in Montgomery form: column l < levels z^(2^l), column
        levels K = 1 / (z^n - 1), the inverse of the product of the n
        denominators z - w_i (0 where z^n = 1, a z in the domain, where
        only the evaluation runs). The evaluations are plain, so K's R
        makes the quotient plain."""
        L, rows = self.levels, []
        for z in zs:
            row = [z % R]
            for _ in range(1, L):
                row.append(row[-1] * row[-1] % R)
            rows.append(row)
        inv = _host_inverses([row[-1] * row[-1] - 1 for row in rows])  # z^n - 1
        raw = b"".join((v * R_MONT % R).to_bytes(32, "little") for row, k in zip(rows, inv) for v in row + [k])
        words = np.frombuffer(raw, dtype="<u4").reshape(len(zs), L + 1, 8)
        return np.ascontiguousarray(words.transpose(0, 2, 1)).view(np.int32)

    def z_table(self, zs) -> torch.Tensor:
        """`z_table_host` on the device, in one transfer."""
        return torch.from_numpy(self.z_table_host(zs)).to(self.device)

    def root_table_host(self, ms) -> np.ndarray:
        """Indices m of zs in the domain, z = w_m -> the table of each z
        that `fr_quotient_in_domain` reads, int32 words [B, 8, levels + 3]
        (the kernel layout): column l < levels z^(2^l), column levels
        K = w_m / n, the inverse of prod_{i != m} (z - w_i) = n / w_m,
        column levels + 1 1/z, all in Montgomery form (K's R makes the
        quotient of plain evaluations plain), and m in word 0 of the last
        column. z = w^k, so its powers and 1/z are roots, looked up."""
        L, n, rows = self.levels, self.n, []
        n_inv = pow(n, -1, R)
        for m in ms:
            k = int(format(m, f"0{L}b")[::-1], 2) if L else 0  # w_m = w^k
            row = [self.roots_ints[(k << lv) % n] for lv in range(L)]
            row += [self.roots_brp_ints[m] * n_inv % R, self.roots_ints[-k % n]]
            rows.append([v * R_MONT % R for v in row] + [m])
        raw = b"".join(v.to_bytes(32, "little") for row in rows for v in row)
        words = np.frombuffer(raw, dtype="<u4").reshape(len(rows), L + 3, 8)
        return np.ascontiguousarray(words.transpose(0, 2, 1)).view(np.int32)

    def root_table(self, ms) -> torch.Tensor:
        """`root_table_host` on the device, in one transfer."""
        return torch.from_numpy(self.root_table_host(ms)).to(self.device)

    # -- the JAX package's jitted kernels: the kernel on a CUDA tensor -------

    def quotient_in_domain(self, plain: torch.Tensor, m) -> torch.Tensor:
        """The quotient at z = w_m (JAX `_quotient_in_domain_kernel`;
        `quotient_in_domain_mont_plain` says what it computes) of plain
        limbs [..., 16, n], m a host int or host ints of the leading shape,
        each in [0, n) -> PLAIN q [..., 16, n]. One `fr_quotient_in_domain`
        launch on the plain limbs of a CUDA tensor, after one transfer of
        their table (`root_table`); on the CPU `FR.to_mont` and the plain
        version, with m as a one-hot mask and 1/z."""
        ms = torch.as_tensor(m)
        lead = torch.broadcast_shapes(plain.shape[:-2], ms.shape)
        plain = plain.expand(tuple(lead) + (16, self.n))
        flat = ms.expand(lead).reshape(-1).tolist()
        if plain.is_cuda:
            return dispatch.fr_quotient_in_domain(plain, flat, self.root_table(flat), self.roots_k)
        onehot = ms.expand(lead).unsqueeze(-1) == torch.arange(self.n)
        z_inv = self.mont([pow(self.roots_brp_ints[i], -1, R) for i in flat]).T.reshape(lead + (16, 1))
        return self.quotient_in_domain_mont_plain(FR.to_mont(plain), onehot, z_inv)

    def open_mont(self, plain: torch.Tensor, zs, quotient: bool = True):
        """Plain evaluations [B, 16, n] and host zs outside the domain (JAX
        `_eval_kernel` and `_quotient_kernel`) -> (PLAIN q [B, 16, n], or
        None where quotient is False, and PLAIN y [B, 16, 1]). On a CUDA
        tensor one `fr_evaluate` and one `fr_quotient` launch on the plain
        limbs as they are, after one transfer of the zs' table (a z in the
        domain passes where quotient is False: y is then its stored
        element); on the CPU the plain reference of that route:
        `FR.to_mont`, `evaluate_mont_plain`, `quotient_mont_plain` and
        `FR.from_mont` of y."""
        if plain.is_cuda:
            return dispatch.fr_open(plain, self.z_table(zs), self.roots_k, self.n_inv_k, quotient)
        z_m, zn1_m = self.z_consts(zs)
        evals_m = FR.to_mont(plain)
        y_m = self.evaluate_mont_plain(evals_m, z_m, zn1_m)
        q = self.quotient_mont_plain(evals_m, y_m, z_m) if quotient else None
        return q, FR.from_mont(y_m)

    def quotient(self, plain: torch.Tensor, z: int, y) -> torch.Tensor:
        """PLAIN q [16, n] of one blob's plain limbs [16, n], a host z and
        the host int y = p(z), unused at a root (JAX
        `quotient_plain_from_mont`): outside the domain
        q_i = (e_i - y) / (w_i - z), one `fr_quotient` launch on a CUDA
        tensor (`quotient_mont_plain` on the CPU); at z = w_m
        `quotient_in_domain`."""
        z %= R
        idx = self.root_index.get(z)
        if idx is not None:
            return self.quotient_in_domain(plain, idx)
        if plain.is_cuda:
            return dispatch.fr_quotient(plain, self.limbs([int(y)]), self.z_table([z]), self.roots_k)
        return self.quotient_mont_plain(FR.to_mont(plain), self.mont([int(y)]), self.mont([z]))

    # -- their plain versions ------------------------------------------------

    def evaluate_mont_plain(self, evals_m, z_m, zn1_m) -> torch.Tensor:
        """y = (z^n - 1) / n * sum_i e_i w_i / (z - w_i) (JAX
        `_eval_kernel`) in PyTorch ops on any device: evals [..., 16, n],
        Montgomery z and z^n - 1 [..., 16, 1], z outside the domain -> y
        [..., 16, 1] in the evaluations' form."""
        target = z_m.shape[:-1] + (self.n,)
        inv_denoms = batch_inv(FR.sub(z_m.expand(target), self.roots_brp.expand(target)))
        terms = FR.mul(FR.mul(evals_m, self.roots_brp), inv_denoms)
        return FR.mul(FR.mul(_sum_tree(terms), zn1_m), self.n_inv)

    def quotient_mont_plain(self, evals_m, y_m, z_m) -> torch.Tensor:
        """q_i = (e_i - y) / (w_i - z) for z outside the domain (JAX
        `_quotient_kernel`) in PyTorch ops on any device: Montgomery evals
        [..., 16, n], y and z [..., 16, 1] -> PLAIN q [..., 16, n]."""
        target = z_m.shape[:-1] + (self.n,)
        shifted = FR.sub(evals_m, y_m.expand(evals_m.shape))
        denoms = FR.sub(self.roots_brp.expand(target), z_m.expand(target))
        return FR.from_mont(FR.mul(shifted, batch_inv(denoms)))

    def quotient_in_domain_mont_plain(self, evals_m, m_onehot, z_inv_m) -> torch.Tensor:
        """`quotient_in_domain` in PyTorch ops on any device, with
        y = e_m:

          q_i = (e_i - y) / (w_i - z)                      for i != m
          q_m = sum_{i != m} (e_i - y) w_i / (z (z - w_i))

        Montgomery evals [..., 16, n] and 1/z [..., 16, 1] -> PLAIN q."""
        y_m = _masked_pick(evals_m, m_onehot)
        z_m = _masked_pick(self.roots_brp, m_onehot)
        target = z_m.shape[:-1] + (self.n,)
        shifted = FR.sub(evals_m, y_m.expand(evals_m.shape))
        denoms = FR.sub(self.roots_brp.expand(target), z_m.expand(target))
        # the zero denominator at m becomes one for the tree, then zero
        safe = lb.select(m_onehot, FR.one_like(denoms), denoms)
        inv_denoms = lb.select(m_onehot, torch.zeros_like(denoms), batch_inv(safe))
        q = FR.mul(shifted, inv_denoms)
        # 1 / (z - w_i) = -inv_denoms_i
        terms = FR.mul(FR.mul(shifted, self.roots_brp), FR.neg(inv_denoms))
        acc = FR.mul(_sum_tree(terms), z_inv_m)
        return FR.from_mont(lb.select(m_onehot, acc.expand(q.shape), q))

    # -- host-facing ---------------------------------------------------------------

    def evaluate_blobs_plain(self, plain: torch.Tensor, zs) -> list:
        """p_b(z_b) for plain limbs [B, 16, n] on the device and host zs,
        in one batched evaluation and one transfer back (y comes out
        plain); a z in the domain takes its blob's stored element (the
        kernel gives it already, the plain version does not)."""
        zs = [z % R for z in zs]
        _, y = self.open_mont(plain, zs, quotient=False)  # [B, 16, 1]
        out = lb.limbs_to_ints(y[..., 0].T)
        for b, z in enumerate(zs):
            idx = self.root_index.get(z)
            if idx is not None:
                out[b] = lb.limbs_to_ints(plain[b, :, idx : idx + 1])[0]
        return out

    def evaluate(self, evals_ints, z: int) -> int:
        """p(z) from evaluation-form ints: the stored element at a root,
        else `open_mont` without a quotient on their plain limbs."""
        z %= R
        idx = self.root_index.get(z)
        if idx is not None:
            return evals_ints[idx] % R
        _, y = self.open_mont(self.limbs(evals_ints)[None], [z], quotient=False)
        return lb.limbs_to_ints(y[0])[0]
