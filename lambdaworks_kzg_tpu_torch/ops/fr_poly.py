"""Evaluation-form polynomials over Fr on limb tensors (plain PyTorch).

The port of the JAX package's `ops/fr_poly.py`: barycentric evaluation
and the KZG quotient on the bit-reversed roots-of-unity domain. Values
are Montgomery Fr limbs [..., 16, n] (`field_ops.FR`) on the domain's
device, with any leading batch dimensions; quotients come out as plain
limbs, the form the fixed-base MSM takes. The JAX package wrote these as
plain XLA, so here they are PyTorch ops on the tensors' device: there is
no kernel, and the code is its own plain version. `host/fft.py` and the
host quotient are the oracles.
"""

import torch

from ..constants import R
from ..host import fft
from . import limbs as lb
from .field_ops import FR


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
    """The domain of size n on one device: the roots in bit-reversed
    order (`roots_brp`, Montgomery [16, n], and `roots_brp_ints` with
    `root_index` on the host) and 1/n."""

    def __init__(self, n: int, device="cpu"):
        if n < 1 or n & (n - 1):
            raise ValueError("the domain size must be a power of two")
        self.n = n
        self.device = torch.device(device)
        self.roots_brp_ints = fft.bit_reversal_permutation(fft.fr_roots_of_unity(n))
        self.root_index = {w: i for i, w in enumerate(self.roots_brp_ints)}
        self.roots_brp = self.mont(self.roots_brp_ints)
        self.n_inv = self.mont([pow(n, R - 2, R)])

    def mont(self, values) -> torch.Tensor:
        """Host ints -> Montgomery limbs [16, len(values)] on the device."""
        return lb.as_limb_tensor(FR.to_mont_host([v % R for v in values]), self.device)

    def z_consts(self, zs):
        """Host zs -> (z, z^n - 1), Montgomery [B, 16, 1] each, in one
        transfer."""
        cols = self.mont(list(zs) + [pow(z, self.n, R) - 1 for z in zs])  # [16, 2B]
        pair = cols.T.reshape(2, len(zs), 16, 1)
        return pair[0], pair[1]

    # -- the JAX package's jitted kernels ------------------------------------

    def evaluate_mont(self, evals_m, z_m, zn1_m) -> torch.Tensor:
        """y = (z^n - 1) / n * sum_i e_i w_i / (z - w_i) (JAX
        `_eval_kernel`): evals [..., 16, n], z and z^n - 1 [..., 16, 1],
        all Montgomery; z outside the domain (a root gives garbage)."""
        target = z_m.shape[:-1] + (self.n,)
        inv_denoms = batch_inv(FR.sub(z_m.expand(target), self.roots_brp.expand(target)))
        terms = FR.mul(FR.mul(evals_m, self.roots_brp), inv_denoms)
        return FR.mul(FR.mul(_sum_tree(terms), zn1_m), self.n_inv)

    def quotient_mont(self, evals_m, y_m, z_m) -> torch.Tensor:
        """q_i = (e_i - y) / (w_i - z) for z outside the domain (JAX
        `_quotient_kernel`): Montgomery evals [..., 16, n] and y, z
        [..., 16, 1] -> PLAIN q [..., 16, n]."""
        target = z_m.shape[:-1] + (self.n,)
        shifted = FR.sub(evals_m, y_m.expand(evals_m.shape))
        denoms = FR.sub(self.roots_brp.expand(target), z_m.expand(target))
        return FR.from_mont(FR.mul(shifted, batch_inv(denoms)))

    def quotient_in_domain_mont(self, evals_m, m_onehot, z_inv_m) -> torch.Tensor:
        """The quotient for z = w_m, m given as a one-hot bool [..., n]
        (JAX `_quotient_in_domain_kernel`), with y = e_m:

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
        in one batched evaluation and one transfer back; a z in the domain
        takes its blob's stored element."""
        zs = [z % R for z in zs]
        z_m, zn1_m = self.z_consts(zs)
        y = FR.from_mont(self.evaluate_mont(FR.to_mont(plain), z_m, zn1_m))  # [B, 16, 1]
        for b, z in enumerate(zs):
            idx = self.root_index.get(z)
            if idx is not None:
                y[b] = plain[b, :, idx : idx + 1]
        return lb.limbs_to_ints(y[..., 0].T)

    def evaluate(self, evals_ints, z: int) -> int:
        """p(z) from evaluation-form ints."""
        z %= R
        idx = self.root_index.get(z)
        if idx is not None:
            return evals_ints[idx] % R
        z_m, zn1_m = self.z_consts([z])
        y = self.evaluate_mont(self.mont(evals_ints), z_m[0], zn1_m[0])
        return FR.from_mont_host(y)[0]

    def quotient_plain_from_mont(self, evals_m: torch.Tensor, z: int, y) -> torch.Tensor:
        """PLAIN quotient limbs [16, n] from Montgomery evals [16, n]; y is
        an int or Montgomery [16, 1] limbs, unused when z is in the domain."""
        z %= R
        idx = self.root_index.get(z)
        if idx is None:
            z_m = self.mont([z])
            y_m = y if isinstance(y, torch.Tensor) else self.mont([int(y)])
            return self.quotient_mont(evals_m, y_m, z_m)
        onehot = torch.arange(self.n, device=self.device) == idx
        return self.quotient_in_domain_mont(evals_m, onehot, self.mont([pow(z, R - 2, R)]))
