"""Montgomery prime-field arithmetic on limb tensors (plain PyTorch).

The port's counterpart of the JAX package's `ops/field_ops.py`: values
are radix-2^16 int64 limbs, limbs-first [..., L, B], in Montgomery form
with R = 2^(16 L). Every result is fully reduced into [0, N), so it is
the same integer as the JAX field's. This module is also the plain
version that the CUDA kernels' Fp (`csrc/fp.cuh`) is held against.

Products are schoolbook column sums (`limbs.conv`); REDC is full-width:
m = (t mod R) N' mod R, then (t + m N) / R, one conditional subtract of
N. Carries are resolved exactly by `limbs.normalize`.

`FP` (24 limbs) holds G1 coordinates; `FR` (16 limbs, R = 2^256, as in
the JAX package) holds the polynomial layer's values (`ops/fr_poly.py`).
"""

import torch

from ..constants import P, R
from . import limbs as lb


class MontgomeryField:
    """A prime field N with L 16-bit limbs, Montgomery arithmetic."""

    def __init__(self, modulus: int, num_limbs: int, name: str):
        if modulus >= 1 << (16 * num_limbs - 1):
            raise ValueError("modulus must be below R/2")
        self.modulus = modulus
        self.L = num_limbs
        self.name = name
        self.R = 1 << (16 * num_limbs)
        self.R2 = self.R * self.R % modulus
        self.one_mont_int = self.R % modulus
        self.n_prime = (-pow(modulus, -1, self.R)) % self.R  # N' = -N^-1 mod R
        self._consts = {}

    def _const(self, name: str, device) -> torch.Tensor:
        """[L, 1] limb constant (N, N', ONE or R2) on `device`, cached."""
        key = (name, str(device))
        if key not in self._consts:
            value = {"N": self.modulus, "NP": self.n_prime,
                     "ONE": self.one_mont_int, "R2": self.R2}[name]
            self._consts[key] = lb.as_limb_tensor(lb.int_to_limbs(value, self.L), device)
        return self._consts[key]

    def one_like(self, a: torch.Tensor) -> torch.Tensor:
        return self._const("ONE", a.device).expand(a.shape).clone()

    # -- host conversions --------------------------------------------------
    def to_mont_host(self, values):
        return lb.ints_to_limbs(
            [v * self.R % self.modulus for v in values], self.L
        )

    def from_mont_host(self, limbs) -> list:
        r_inv = pow(self.R, -1, self.modulus)
        return [v * r_inv % self.modulus for v in lb.limbs_to_ints(limbs)]

    # -- core ops -----------------------------------------------------------
    def _redc_cols(self, t: torch.Tensor) -> torch.Tensor:
        """Unnormalized 2L-limb columns (each < 2^38) -> t R^-1 mod N.

        m = (t mod R) N' mod R makes t + m N a multiple of R; t mod R is
        the low L columns unnormalized (their products with N' stay below
        2^59), and only m itself needs exact carries."""
        L = self.L
        m = lb.conv(t[..., :L, :], self._const("NP", t.device), L)
        m = lb.normalize(m, rounds=3)
        u = t + lb.conv(m, self._const("N", t.device), 2 * L)
        u = torch.cat([u, torch.zeros_like(u[..., :1, :])], dim=-2)
        u = lb.normalize(u, rounds=2)
        return self._sub_n_if_ge(u[..., L : 2 * L, :])  # u / R < 2N < R

    def _sub_n_if_ge(self, x: torch.Tensor) -> torch.Tensor:
        d, ge = self._sub_borrow(x, self._const("N", x.device))
        return lb.select(ge, d, x)

    def _sub_borrow(self, a, b):
        """((a - b) mod 2^(16 L), a >= b) for normalized a, b."""
        t = a + (lb.MASK16 - b)
        t = torch.cat(
            [t[..., :1, :] + 1, t[..., 1:, :], torch.zeros_like(t[..., :1, :])],
            dim=-2,
        )
        t = lb.normalize(t)
        return t[..., : self.L, :], t[..., self.L, :] > 0

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._redc_cols(lb.conv(a, b, 2 * self.L))

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._sub_n_if_ge(lb.normalize(a + b))  # a + b < 2N < R

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d, ge = self._sub_borrow(a, b)
        n = self._const("N", d.device)
        return lb.select(ge, d, lb.normalize(d + n))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        n = self._const("N", a.device).expand(a.shape)
        d, _ = self._sub_borrow(n, a)
        return lb.select(self.is_zero(a), a, d)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self._const("R2", a.device))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self._redc_cols(torch.cat([a, torch.zeros_like(a)], dim=-2))

    def pow_fixed(self, a: torch.Tensor, exponent: int) -> torch.Tensor:
        """a^exponent for an exponent known on the host: square and
        multiply over its bits, from the lowest (a^0 is one)."""
        res = self.one_like(a)
        base = a
        while exponent:
            if exponent & 1:
                res = self.mul(res, base)
            exponent >>= 1
            if exponent:
                base = self.sqr(base)
        return res

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inversion a^(N-2); maps 0 to 0."""
        return self.pow_fixed(a, self.modulus - 2)

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return torch.all(a == 0, dim=-2)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(a == b, dim=-2)


FP = MontgomeryField(P, 24, "fp")
FR = MontgomeryField(R, 16, "fr")
