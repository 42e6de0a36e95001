"""Trusted setup: text parsing, digest, conversion and the converted-setup
cache.

A setup file (`n1\\nn2\\n<hex>...`) stores G1 powers in monomial form;
commitments need the bit-reversed Lagrange basis. Converting one runs on
a device (`_convert_g1`, the JAX package's `_convert_g1_device`): one
batched decompression and subgroup check of the n G1 points and an
inverse G1 group FFT (`convert_g1_device`, on `ops/g1_batch.py`: the
Hopper kernels on a CUDA device), then the bit reversal and the affine
step on the host. The G2
powers are decompressed on the host. A conversion is cached by the
setup's digest in the JAX package's format (`lagrange`, `monomial`,
`g2` as uint8 rows) and under its name, so either package reads the
other's; the repository ships the mainnet conversion as
`cache/srs_mainnet.npz`. The cache also holds the monomial G1 powers and
the G2 powers [s^i]G2, of which verification uses [1]_2 and [s]_2.
"""

import hashlib
import os
import secrets
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..constants import NUM_G2_POINTS, R, TRUSTED_SETUP_NUM_G1_POINTS
from ..host import curve as C
from ..host import fft as FFT
from ..ops import g1_batch, g1_ops
from ..ops.dispatch import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_REPO, "cache")
MAINNET_SETUP_PATH = os.path.join(_REPO, "testdata", "trusted_setup.txt")
# sha256 of the mainnet setup's G1 bytes, "|", G2 bytes; its conversion
# ships as cache/srs_mainnet.npz
MAINNET_DIGEST = "62bcf72bba2b37b82876acbd149e614cb64eb09eb400812e50fd49f98785815a"


class SetupLoadError(ValueError):
    pass


@dataclass
class TrustedSetup:
    """The commitment basis of one setup.

    lagrange_points: uint32[2, 24, n], Montgomery affine coordinates of
                     the bit-reversed Lagrange basis (radix-2^16 limbs)
    lagrange_valid : bool[n], False for a point at infinity
    g1_monomial    : affine G1 points [s^i]G, (x, y) ints or None
    g2_monomial    : affine G2 points [s^i]G2, ((x0, x1), (y0, y1)) or
                     None; empty for a setup that only commits
    """

    lagrange_points: np.ndarray
    lagrange_valid: np.ndarray
    source_digest: str
    g1_monomial: list = field(default_factory=list)
    g2_monomial: list = field(default_factory=list)

    @property
    def n(self) -> int:
        return self.lagrange_points.shape[-1]


def _parse_setup_text(text: str):
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if len(lines) < 2:
        raise SetupLoadError("missing headers")
    try:
        n1, n2 = int(lines[0]), int(lines[1])
    except ValueError as e:
        raise SetupLoadError(f"bad headers: {e}") from e
    if len(lines) != 2 + n1 + n2:
        raise SetupLoadError("line count mismatch")
    try:
        g1 = [bytes.fromhex(ln) for ln in lines[2 : 2 + n1]]
        g2 = [bytes.fromhex(ln) for ln in lines[2 + n1 :]]
    except ValueError as e:
        raise SetupLoadError(f"bad hex: {e}") from e
    if any(len(b) != 48 for b in g1) or any(len(b) != 96 for b in g2):
        raise SetupLoadError("bad point byte length")
    return g1, g2


def setup_digest(g1_bytes, g2_bytes) -> str:
    return hashlib.sha256(b"".join(g1_bytes) + b"|" + b"".join(g2_bytes)).hexdigest()


def _affine_g1_to_u8(points) -> np.ndarray:
    """Affine points ((x, y) or None) -> uint8[n, 97] rows flag || x || y."""
    out = np.zeros((len(points), 97), dtype=np.uint8)
    for i, pt in enumerate(points):
        if pt is not None:
            out[i, 0] = 1
            out[i, 1:] = np.frombuffer(pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big"),
                                       dtype=np.uint8)
    return out


def _affine_g2_to_u8(points) -> np.ndarray:
    """Affine G2 points -> uint8[n, 193] rows flag || x0 || x1 || y0 || y1."""
    out = np.zeros((len(points), 193), dtype=np.uint8)
    for i, pt in enumerate(points):
        if pt is not None:
            (x0, x1), (y0, y1) = pt
            out[i, 0] = 1
            out[i, 1:] = np.frombuffer(b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1)),
                                       dtype=np.uint8)
    return out


def _affine_g1_from_u8(arr: np.ndarray):
    """uint8[n, 97] rows flag || x (48, big-endian) || y (48) -> list of
    (x, y) or None."""
    out = []
    for row in arr:
        if row[0] == 0:
            out.append(None)
        else:
            out.append((int.from_bytes(row[1:49].tobytes(), "big"),
                        int.from_bytes(row[49:].tobytes(), "big")))
    return out


def _affine_g2_from_u8(arr: np.ndarray):
    """uint8[n, 193] rows flag || x0 || x1 || y0 || y1 (48 bytes each,
    big-endian) -> list of ((x0, x1), (y0, y1)) or None."""
    out = []
    for row in arr:
        if row[0] == 0:
            out.append(None)
        else:
            v = [int.from_bytes(row[1 + 48 * j : 49 + 48 * j].tobytes(), "big") for j in range(4)]
            out.append(((v[0], v[1]), (v[2], v[3])))
    return out


def _cache_path(digest: str, cache_dir: str) -> str:
    if digest == MAINNET_DIGEST:
        return os.path.join(cache_dir, "srs_mainnet.npz")
    return os.path.join(cache_dir, f"srs_{digest[:16]}.npz")


def setup_from_cache(path: str, digest: str) -> TrustedSetup:
    with np.load(path) as data:
        lagrange = _affine_g1_from_u8(data["lagrange"])
        monomial = _affine_g1_from_u8(data["monomial"])
        g2 = _affine_g2_from_u8(data["g2"])
    points, valid = g1_ops.make_points_host(lagrange)
    return TrustedSetup(points, valid, digest, monomial, g2)


def _decompress_g2_list(g2_bytes):
    """The G2 powers, decompressed and subgroup-checked on the host."""
    out = []
    for i, b in enumerate(g2_bytes):
        try:
            pt = C.decompress_g2(b, subgroup_check=True)
        except C.DeserializationError as e:
            raise SetupLoadError(f"bad g2 point at index {i}: {e}") from e
        out.append(C.g2_to_affine(pt))
    return out


def convert_g1_device(g1_bytes, device):
    """The device part of a conversion: monomial G1 powers (compressed) ->
    (monomial, Lagrange in natural order), Jacobian [3, 24, n] on `device`,
    by one batched decompression and subgroup check and one inverse G1
    FFT. SetupLoadError names the first bad point."""
    pts_aff, is_inf, err = g1_batch.decompress_batch(list(g1_bytes), device=device)
    if err.any():
        raise SetupLoadError(f"bad g1 point at index {int(np.argmax(err))}")
    jac = g1_batch.lift_affine(pts_aff, torch.from_numpy(~is_inf).to(device))
    # every point passed the subgroup check above, so the FFT may split its
    # scalars through the G1 endomorphism
    return jac, g1_batch.g1_fft_device(jac, inverse=True, in_g1=True)


def _convert_g1(g1_bytes, device):
    """Monomial G1 powers (compressed) -> (monomial, bit-reversed Lagrange)
    host affine lists: `convert_g1_device`, then the bit reversal and the
    affine step on the host."""
    jac, lagrange_jac = convert_g1_device(g1_bytes, device)
    brp = torch.tensor(FFT.bit_reversal_permutation(list(range(len(g1_bytes)))), device=device)
    lagrange = g1_batch.jacobians_to_host_affine(lagrange_jac.index_select(-1, brp))
    return g1_batch.jacobians_to_host_affine(jac), lagrange


def _setup_from_lists(lagrange, monomial, g2, digest: str) -> TrustedSetup:
    points, valid = g1_ops.make_points_host(lagrange)
    return TrustedSetup(points, valid, digest, list(monomial), list(g2))


def load_trusted_setup_from_bytes(g1_bytes, g2_bytes, use_cache: bool = True,
                                  strict_counts: bool = True, cache_dir: Optional[str] = None,
                                  device="cuda") -> TrustedSetup:
    """A setup from its compressed points: read from the cache when one
    holds this digest, else converted on `device` and cached in
    `cache_dir` (default: `CACHE_DIR`, read when called). The device
    is resolved only for a conversion, which raises where CUDA is asked
    for and absent; an existing cache file is never overwritten.
    strict_counts: exactly 4096 G1 and 65 G2 points, as the mainnet file."""
    if strict_counts and (len(g1_bytes) != TRUSTED_SETUP_NUM_G1_POINTS
                          or len(g2_bytes) != NUM_G2_POINTS):
        raise SetupLoadError("bad point counts")
    n1 = len(g1_bytes)
    if n1 < 2 or n1 & (n1 - 1):
        raise SetupLoadError("g1 count must be a power of two")
    digest = setup_digest(g1_bytes, g2_bytes)
    cache = _cache_path(digest, cache_dir or CACHE_DIR)
    if use_cache and os.path.exists(cache):
        setup = setup_from_cache(cache, digest)
        if setup.n != n1:
            raise SetupLoadError(f"cache {cache} holds {setup.n} points, not {n1}")
        return setup
    device = resolve_device(device)
    g2 = _decompress_g2_list(g2_bytes)
    monomial, lagrange = _convert_g1(g1_bytes, device)
    if use_cache:
        _write_cache(cache, lagrange, monomial, g2)
    return _setup_from_lists(lagrange, monomial, g2, digest)


def _write_cache(path: str, lagrange, monomial, g2) -> None:
    """Write the conversion unless a file of that name exists."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path, "xb") as f:
            np.savez_compressed(f, lagrange=_affine_g1_to_u8(lagrange),
                                monomial=_affine_g1_to_u8(monomial), g2=_affine_g2_to_u8(g2))
    except FileExistsError:
        pass


def load_trusted_setup_file(path: str, cache_dir: Optional[str] = None, device="cuda",
                            use_cache: bool = True) -> TrustedSetup:
    """A setup file (any power-of-two G1 count), from its cache or
    converted on `device`."""
    with open(path, "r", encoding="utf-8") as f:
        g1_bytes, g2_bytes = _parse_setup_text(f.read())
    return load_trusted_setup_from_bytes(g1_bytes, g2_bytes, use_cache=use_cache,
                                         strict_counts=False, cache_dir=cache_dir, device=device)


def load_mainnet_setup(use_cache: bool = True, device="cuda") -> TrustedSetup:
    """The mainnet setup from `testdata/trusted_setup.txt` (its conversion
    read from the cache, or made on `device`); where that file is absent,
    the repository's `cache/srs_mainnet.npz`, as the JAX package falls
    back to it."""
    if os.path.exists(MAINNET_SETUP_PATH):
        return load_trusted_setup_file(MAINNET_SETUP_PATH, device=device, use_cache=use_cache)
    cache = _cache_path(MAINNET_DIGEST, CACHE_DIR)
    if os.path.exists(cache):
        return setup_from_cache(cache, MAINNET_DIGEST)
    raise SetupLoadError("no mainnet trusted setup file found")


def create_dev_setup(n: int = 64, secret=None) -> TrustedSetup:
    """A small insecure setup for tests, on the host: n monomial G1 powers
    [s^i]G, their bit-reversed Lagrange basis and the G2 powers [1]_2,
    [s]_2; deterministic when `secret` is given (the JAX package's
    `create_dev_setup`)."""
    if n < 2 or n & (n - 1):
        raise SetupLoadError("n must be a power of two >= 2")
    s = (secret if secret is not None else secrets.randbelow(R - 2) + 1) % R
    monomial_jac, acc = [], 1
    for _ in range(n):
        monomial_jac.append(C.point_scalar_mul(C.G1_GENERATOR, acc))
        acc = acc * s % R
    g2 = [C.g2_to_affine(C.g2_scalar_mul(C.G2_GENERATOR, k)) for k in (1, s)]
    lagrange_jac = FFT.bit_reversal_permutation(FFT.g1_fft(monomial_jac, inverse=True))
    return _setup_from_lists([C.to_affine(pt) for pt in lagrange_jac],
                             [C.to_affine(pt) for pt in monomial_jac], g2, f"dev-{n}")
