"""Python side of the port's C ABI (`capi/shim.c`), the c-kzg-4844
minimal interface over `EIP4844Context`.

Every function returns a (ret_code, payload) tuple instead of raising, so
the C layer only unpacks: no exception crosses the embedding boundary.
The codes are c-kzg-4844's C_KZG_RET: 0 OK, 1 BADARGS (a SetupLoadError
or a KZGError), 2 ERROR (anything else, a missing CUDA device among
them), 3 MALLOC (set by the shim).

A context takes its device from the environment (`KZGConfig.from_env`):
the card, unless LWKZG_BACKEND=host puts it on the CPU. Without CUDA and
without LWKZG_BACKEND=host, loading a setup returns C_KZG_ERROR with the
error's text; it never falls back to the CPU. A setup with no cached
conversion is converted on the context's device into `srs.CACHE_DIR`.
"""

from typing import Tuple

from .models.eip4844 import EIP4844Context, KZGError
from .models.srs import SetupLoadError, _parse_setup_text, load_trusted_setup_from_bytes
from .utils.config import KZGConfig

C_KZG_OK = 0
C_KZG_BADARGS = 1
C_KZG_ERROR = 2


def _wrap(fn):
    try:
        return C_KZG_OK, fn()
    except (SetupLoadError, KZGError) as e:
        return C_KZG_BADARGS, str(e).encode()
    except Exception as e:  # anything unexpected, a missing CUDA device among them
        return C_KZG_ERROR, str(e).encode()


def _context(g1, g2, strict_counts: bool) -> EIP4844Context:
    config = KZGConfig.from_env()
    device = config.device()
    setup = load_trusted_setup_from_bytes(g1, g2, strict_counts=strict_counts, device=device)
    return EIP4844Context(setup, device=device, config=config)


def new_context_from_parts(g1_bytes: bytes, n1: int, g2_bytes: bytes, n2: int) -> Tuple[int, object]:
    """load_trusted_setup: exactly 4096 G1 and 65 G2 points, else BADARGS."""

    def go():
        g1 = [bytes(g1_bytes[i * 48 : (i + 1) * 48]) for i in range(n1)]
        g2 = [bytes(g2_bytes[i * 96 : (i + 1) * 96]) for i in range(n2)]
        return _context(g1, g2, strict_counts=True)

    return _wrap(go)


def new_context_from_text(text: bytes) -> Tuple[int, object]:
    """load_trusted_setup_file: a setup file of any power-of-two G1 count."""

    def go():
        g1, g2 = _parse_setup_text(text.decode("utf-8"))
        return _context(g1, g2, strict_counts=False)

    return _wrap(go)


def blob_size(ctx: EIP4844Context) -> int:
    return ctx.n * 32


def blob_to_kzg_commitment(ctx, blob: bytes) -> Tuple[int, bytes]:
    return _wrap(lambda: ctx.blob_to_kzg_commitment(blob))


def compute_kzg_proof(ctx, blob: bytes, z: bytes) -> Tuple[int, bytes]:
    """Returns proof (48 bytes) || y (32 bytes)."""

    def go():
        proof, y = ctx.compute_kzg_proof(blob, z)
        return proof + y

    return _wrap(go)


def compute_blob_kzg_proof(ctx, blob: bytes, commitment: bytes) -> Tuple[int, bytes]:
    return _wrap(lambda: ctx.compute_blob_kzg_proof(blob, commitment))


def verify_kzg_proof(ctx, c: bytes, z: bytes, y: bytes, p: bytes):
    return _wrap(lambda: ctx.verify_kzg_proof(c, z, y, p))


def verify_blob_kzg_proof(ctx, blob: bytes, c: bytes, p: bytes):
    return _wrap(lambda: ctx.verify_blob_kzg_proof(blob, c, p))


def verify_blob_kzg_proof_batch(ctx, blobs: bytes, cs: bytes, ps: bytes, n: int):
    def go():
        size = ctx.n * 32
        return ctx.verify_blob_kzg_proof_batch(
            [blobs[i * size : (i + 1) * size] for i in range(n)],
            [cs[i * 48 : (i + 1) * 48] for i in range(n)],
            [ps[i * 48 : (i + 1) * 48] for i in range(n)],
        )

    return _wrap(go)


# -- blst-layout point tables (the C-readable contents of KZGSettings) --------
#
# c-kzg-4844's KZGSettings carries point arrays a C caller may read:
# blst_p1 / blst_p2 structs of CANONICAL (non-Montgomery) coordinates, the
# u64 words most significant first (l[0] is the top word, each word in
# native little-endian byte order), projective z = 1. The entry points
# never read them: the converted setup lives on the device.


def _fp_words_mem(v: int) -> bytes:
    """The 48-byte memory image of blst_fp {u64 l[6]}, l[0] the most
    significant word."""
    be = v.to_bytes(48, "big")
    return b"".join(be[i * 8 : (i + 1) * 8][::-1] for i in range(6))


def _p1_mem(aff) -> bytes:
    if aff is None:  # infinity: x = y = 0, z = 1
        return _fp_words_mem(0) * 2 + _fp_words_mem(1)
    return _fp_words_mem(aff[0]) + _fp_words_mem(aff[1]) + _fp_words_mem(1)


def _p2_mem(aff) -> bytes:
    if aff is None:
        return _fp_words_mem(0) * 4 + _fp_words_mem(1) + _fp_words_mem(0)
    (x0, x1), (y0, y1) = aff
    return b"".join(_fp_words_mem(v) for v in (x0, x1, y0, y1, 1, 0))


def blst_tables(ctx: EIP4844Context) -> Tuple[int, tuple]:
    """(g1_table, g2_table): n1 blst_p1 (144 bytes each) of the monomial
    G1 powers, as loaded from the setup, and n2 blst_p2 (288 bytes each)."""

    def go():
        s = ctx.setup
        return (b"".join(_p1_mem(a) for a in s.g1_monomial),
                b"".join(_p2_mem(a) for a in s.g2_monomial))

    return _wrap(go)
