"""The radix-2 NTT over Fr in plain PyTorch (the JAX package's
`ops/ntt.py`, which is XLA there and has no Pallas kernel).

Values are Montgomery Fr limbs, radix-2^16 int64, limbs first
[..., 16, n] with the domain on the last axis (`field_ops.FR`). A
transform is one gather into bit-reversed order, then one stage per
power of two: a product with the stage's twiddle plane, a sum and a
difference on n/2 lanes, and reshapes. Natural order in and out, the
semantics of `host/fft.fr_fft`, which is the oracle.
"""

import torch

from ..constants import R
from ..host import fft as HFFT
from . import limbs as lb
from .dispatch import resolve_device
from .field_ops import FR


class NTTPlan:
    """The constants of one domain size n on one device: the
    bit-reversal index and, per stage, a [16, n/2] Montgomery twiddle
    plane in each direction."""

    def __init__(self, n: int, device):
        if n < 2 or n & (n - 1):
            raise ValueError(f"the NTT length must be a power of two >= 2, got {n}")
        self.n = n
        self.device = torch.device(device)
        self.brp_idx = torch.tensor(HFFT.bit_reversal_permutation(list(range(n))), device=device)
        self.tw_fwd = self._twiddle_planes(inverse=False)
        self.tw_inv = self._twiddle_planes(inverse=True)
        self.n_inv_mont = lb.as_limb_tensor(FR.to_mont_host([pow(n, R - 2, R)]), device)

    def _twiddle_planes(self, inverse: bool):
        """Stage of block `length`: butterfly lane b = g half + j takes
        w_length^j (the groups g laid out one after another)."""
        planes = []
        length = 2
        while length <= self.n:
            tw = HFFT.fr_roots_of_unity(length, inverse)[: length // 2]
            plane = FR.to_mont_host(tw * (self.n // length))
            planes.append(lb.as_limb_tensor(plane, self.device))
            length *= 2
        return planes


_plans = {}


def get_plan(n: int, device="cuda") -> NTTPlan:
    """The cached plan of size n on `device` (the card unless the caller
    asks for the CPU; CUDA that is not there raises)."""
    device = resolve_device(device)
    key = (n, str(device))
    if key not in _plans:
        _plans[key] = NTTPlan(n, device)
    return _plans[key]


def _butterfly_stage(x: torch.Tensor, tw: torch.Tensor, length: int) -> torch.Tensor:
    """One Cooley-Tukey stage on [..., 16, n]: (e, o) -> (e + tw o, e - tw o)."""
    lead, n = x.shape[:-1], x.shape[-1]
    half = length // 2
    x4 = x.reshape(lead + (n // length, length))
    even = x4[..., :half].reshape(lead + (n // 2,))
    odd = x4[..., half:].reshape(lead + (n // 2,))
    t = FR.mul(odd, tw)
    out_e = FR.add(even, t).reshape(lead + (n // length, half))
    out_o = FR.sub(even, t).reshape(lead + (n // length, half))
    return torch.cat([out_e, out_o], dim=-1).reshape(lead + (n,))


def ntt_device(x_mont: torch.Tensor, inverse: bool = False, scale: bool = True) -> torch.Tensor:
    """Montgomery [..., 16, n] -> the same shape, natural order in and out
    on the last axis, on x_mont's device. `scale=False` leaves out the
    inverse transform's factor 1/n."""
    plan = get_plan(x_mont.shape[-1], x_mont.device)
    x = x_mont.index_select(-1, plan.brp_idx)
    length = 2
    for tw in plan.tw_inv if inverse else plan.tw_fwd:
        x = _butterfly_stage(x, tw, length)
        length *= 2
    if inverse and scale:
        x = FR.mul(x, plan.n_inv_mont)
    return x


def ntt_ints(values, inverse: bool = False, device="cuda"):
    """Python ints -> Python ints through `ntt_device` on `device`."""
    device = resolve_device(device)
    x = lb.as_limb_tensor(FR.to_mont_host([v % R for v in values]), device)
    return FR.from_mont_host(ntt_device(x, inverse=inverse))
