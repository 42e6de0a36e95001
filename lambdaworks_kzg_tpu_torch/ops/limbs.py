"""Multi-limb integers as tensors, and the two limb layouts.

Public layout (the JAX package's): radix 2^16, limbs-first
[..., L, B] with the batch on the last axis, little-endian limbs. Torch
on the CPU cannot add, shift or compare uint32, so these tensors are
int64; every limb is < 2^16 between operations.

Kernel layout: radix 2^32, [..., L/2, B] int32 tensors holding the u32
bit pattern (the CUDA kernels read them as uint32). Montgomery form with
R = 2^384 is the same integer in both layouts; only the radix changes.
"""

import numpy as np
import torch
import torch.nn.functional as F

MASK16 = 0xFFFF


# -- host conversions (numpy) ----------------------------------------------


def ints_to_limbs(values, num_limbs: int) -> np.ndarray:
    """Iterable of ints -> uint32[num_limbs, len(values)], radix 2^16."""
    values = list(values)
    raw = b"".join(int(v).to_bytes(2 * num_limbs, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<u2").reshape(len(values), num_limbs)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_ints(limbs) -> list:
    """[L, B] radix-2^16 limbs (numpy or tensor) -> list of B ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u2").T)
    width = arr.shape[1] * 2
    raw = arr.tobytes()
    return [
        int.from_bytes(raw[i : i + width], "little")
        for i in range(0, len(raw), width)
    ]


def int_to_limbs(value: int, num_limbs: int) -> np.ndarray:
    """int -> uint32[num_limbs, 1] (broadcastable constant)."""
    return ints_to_limbs([value], num_limbs)


# -- tensor helpers ----------------------------------------------------------


def as_limb_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy radix-2^16 limbs (any unsigned dtype) -> contiguous int64
    tensor (one copy on the host, whatever the array's strides)."""
    return torch.from_numpy(np.asarray(arr).astype(np.int64, order="C")).to(device)


def shift_up(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Shift limbs (axis -2) toward the MSB by k positions, zero fill."""
    return F.pad(x, (0, 0, k, 0))[..., : x.shape[-2], :]


def normalize(t: torch.Tensor, rounds: int = 0) -> torch.Tensor:
    """Limbs (axis -2) -> limbs below 2^16 with exact carries; the carry
    out of the top limb is dropped.

    Each limb must be below 2^(16 + 16 rounds): `rounds` carry-save
    rounds bring every limb to at most 2^17 - 2 (for rounds = 0 the input
    limbs above the lowest must already be). The remaining 0/1 carries
    are resolved at once: the carry out of limb k is 1 exactly when the
    last limb at or below k that does not propagate (a generate, or
    low bits other than 0xFFFF) generates, found with one running maximum
    over coded limb positions."""
    for _ in range(rounds):
        t = (t & MASK16) + shift_up(t >> 16)
    gen = t >> 16
    low = t & MASK16
    # events: a generate (odd code) or a kill (even code) at limb k, coded
    # 2k + gen; propagating limbs (low == 0xFFFF, no generate) are -1
    pos = torch.arange(0, 2 * t.shape[-2], 2, device=t.device).unsqueeze(-1)
    events = torch.where((gen > 0) | (low != MASK16), pos + gen, -1)
    last = events.cummax(dim=-2).values
    carry = (last >= 0) & ((last & 1) > 0)
    return (low + shift_up(carry)) & MASK16


_GATHER_ELEMENTS = 1 << 17  # below this many products, one gathered product
_toeplitz_cache = {}


def _toeplitz_index(a_limbs: int, b_limbs: int, out_limbs: int, device) -> torch.Tensor:
    """[out_limbs, a_limbs] indices k - i into b's limbs, or b_limbs (a
    zero limb appended to b) where k - i is out of range."""
    key = (a_limbs, b_limbs, out_limbs, str(device))
    if key not in _toeplitz_cache:
        d = torch.arange(out_limbs)[:, None] - torch.arange(a_limbs)[None, :]
        ok = (d >= 0) & (d < b_limbs)
        _toeplitz_cache[key] = torch.where(ok, d, b_limbs).to(device)
    return _toeplitz_cache[key]


def conv(a: torch.Tensor, b: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Unnormalized column sums of the schoolbook product a * b, limbs on
    axis -2, truncated to `out_limbs` columns. b may be a [L, 1] constant.

    Few lanes: one product of a against a gathered Toeplitz stack of b
    (a handful of ops). Many lanes: one broadcast multiply-add of b's
    rows per limb of a, which never forms the [K, L, B] stack."""
    L, Lb = a.shape[-2], b.shape[-2]
    lanes = max(a.shape[-1], b.shape[-1])
    if lanes * L * out_limbs <= _GATHER_ELEMENTS:
        b_pad = torch.cat([b, torch.zeros_like(b[..., :1, :])], dim=-2)
        b_t = b_pad[..., _toeplitz_index(L, Lb, out_limbs, b.device), :]
        return (b_t * a.unsqueeze(-3)).sum(dim=-2)
    shape = torch.broadcast_shapes(a.shape[:-2] + a.shape[-1:], b.shape[:-2] + b.shape[-1:])
    cols = torch.zeros(shape[:-1] + (out_limbs,) + shape[-1:], dtype=torch.int64,
                       device=a.device)
    for i in range(min(L, out_limbs)):
        w = min(Lb, out_limbs - i)
        cols[..., i : i + w, :] += a[..., i : i + 1, :] * b[..., :w, :]
    return cols


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b; mask [..., B] broadcasts over the limb axis."""
    return torch.where(mask.unsqueeze(-2), a, b)


# -- layout conversion -------------------------------------------------------


def to_u32_layout(x16: torch.Tensor) -> torch.Tensor:
    """[..., 2K, B] radix-2^16 int64 -> [..., K, B] radix-2^32 int32
    (u32 bit pattern), contiguous."""
    v = x16[..., 0::2, :] | (x16[..., 1::2, :] << 16)
    v = torch.where(v >= (1 << 31), v - (1 << 32), v)
    return v.to(torch.int32).contiguous()


def to_u16_layout(x32: torch.Tensor) -> torch.Tensor:
    """[..., K, B] radix-2^32 int32 -> [..., 2K, B] radix-2^16 int64."""
    v = x32.to(torch.int64) & 0xFFFFFFFF
    pair = torch.stack([v & MASK16, v >> 16], dim=-2)  # [..., K, 2, B]
    return pair.reshape(x32.shape[:-2] + (2 * x32.shape[-2], x32.shape[-1]))
