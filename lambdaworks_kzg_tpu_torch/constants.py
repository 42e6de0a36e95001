"""Protocol and BLS12-381 constants (the port's own copy).

Blobs are 4096 little-endian Fr elements in evaluation form over the
bit-reversed roots-of-unity domain; the commitment basis is the
bit-reversed Lagrange form of the trusted setup's G1 powers.
"""

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = BYTES_PER_FIELD_ELEMENT * FIELD_ELEMENTS_PER_BLOB  # 131072
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48

# Fiat-Shamir domain separators of the challenge hashes
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"

# Base field prime p (381 bits) and scalar field prime r (255 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# G1: y^2 = x^3 + 4 over Fp; G2 on the twist y^2 = x^3 + 4 (u + 1) over Fp2
B_G1 = 4
B_G2 = (4, 4)  # Fp2 elements are (c0, c1) = c0 + c1 u, u^2 = -1
BLS_X = -0xD201000000010000
# cube root of unity in Fp acting as multiplication by -BLS_X^2 on G1
G1_BETA = 0x5F19672FDF76CE51BA69C6076A0F77EADDB3A93BE6F89688DE17D813620A00022E01FFFFFFFEFFFE

# G1 decompression: p = 3 mod 4, so sqrt(a) = a^((p+1)/4) when a is a
# square; y is the "lexicographically largest" root when y > (p-1)/2
FP_SQRT_EXP = (P + 1) // 4
FP_HALF = (P - 1) // 2
B_G1_MONT = (B_G1 << 384) % P  # b = 4 in Montgomery form (R = 2^384)

G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# psi(x, y) = (PSI_X conj(x), PSI_Y conj(y)), the untwist-Frobenius-twist
# endomorphism, acts as multiplication by BLS_X on G2
PSI_X = (
    0x0,
    0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAD,
)
PSI_Y = (
    0x135203E60180A68EE2E9C448D77A2CD91C3DEDD930B1CF60EF396489F61EB45E304466CF3E67FA0AF1EE7B04121BDEA2,
    0x06AF0E0437FF400B6831E36D6BD17FFE48395DABC2D3435E77F76E17009241C5EE67992F72EC05F4C81084FBEDE3CC09,
)

G2_GENERATOR_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GENERATOR_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# The trusted setup: G1 and G2 powers in the mainnet file
TRUSTED_SETUP_NUM_G1_POINTS = FIELD_ELEMENTS_PER_BLOB
NUM_G2_POINTS = 65

# The MSMs split a scalar into windows of c bits: the fixed-base MSM's
# tables cover 256 bits, the generic MSM's windows its scalar bound


def num_windows(c: int, scalar_bits: int = 256) -> int:
    """Windows of c bits that cover a scalar below 2^scalar_bits:
    ceil(scalar_bits / c)."""
    return (scalar_bits + c - 1) // c


PRIMITIVE_ROOT_OF_UNITY = 7
FR_TWO_ADICITY = 32


def fr_root_of_unity(order: int) -> int:
    """Primitive `order`-th root of unity in Fr (order must divide 2^32)."""
    if order & (order - 1) or order > (1 << FR_TWO_ADICITY):
        raise ValueError(f"no root of unity of order {order}")
    return pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // order, R)
