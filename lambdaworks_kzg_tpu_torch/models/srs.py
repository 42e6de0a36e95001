"""Trusted setup: text parsing, digest, and the converted-setup cache.

A setup file (`n1\\nn2\\n<hex>...`) stores G1 powers in monomial form;
commitments need the bit-reversed Lagrange basis. Converting one
(4096 decompressions, subgroup checks and an inverse G1 group FFT) is
not part of this package yet: it reads the converted cache that the
repository ships, chosen by the setup's digest, and raises for a setup
without one. Small setups for tests come through `convert.py`. The
cache also holds the monomial G1 powers and the G2 powers [s^i]G2, of
which verification uses [1]_2 and [s]_2.
"""

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from ..ops import g1_ops

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


def load_trusted_setup_file(path: str, cache_dir: str = CACHE_DIR) -> TrustedSetup:
    with open(path, "r", encoding="utf-8") as f:
        g1_bytes, g2_bytes = _parse_setup_text(f.read())
    n1 = len(g1_bytes)
    if n1 < 2 or n1 & (n1 - 1):
        raise SetupLoadError("g1 count must be a power of two")
    digest = setup_digest(g1_bytes, g2_bytes)
    cache = _cache_path(digest, cache_dir)
    if not os.path.exists(cache):
        raise SetupLoadError(
            f"no converted cache for setup {digest[:16]} ({n1} G1 points) at "
            f"{cache}: converting a setup is not supported by this package yet"
        )
    setup = setup_from_cache(cache, digest)
    if setup.n != n1:
        raise SetupLoadError(f"cache {cache} holds {setup.n} points, not {n1}")
    return setup


def load_mainnet_setup() -> TrustedSetup:
    return load_trusted_setup_file(MAINNET_SETUP_PATH)
