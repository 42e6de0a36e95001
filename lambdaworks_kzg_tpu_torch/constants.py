"""Protocol and BLS12-381 constants (the port's own copy).

Blobs are 4096 little-endian Fr elements in evaluation form over the
bit-reversed roots-of-unity domain; the commitment basis is the
bit-reversed Lagrange form of the trusted setup's G1 powers.
"""

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_BLOB = 32 * FIELD_ELEMENTS_PER_BLOB  # 131072
BYTES_PER_COMMITMENT = 48

# Base field prime p (381 bits) and scalar field prime r (255 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# G1: y^2 = x^3 + 4 over Fp
B_G1 = 4
BLS_X = -0xD201000000010000
# cube root of unity in Fp acting as multiplication by -BLS_X^2 on G1
G1_BETA = 0x5F19672FDF76CE51BA69C6076A0F77EADDB3A93BE6F89688DE17D813620A00022E01FFFFFFFEFFFE

G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

PRIMITIVE_ROOT_OF_UNITY = 7
FR_TWO_ADICITY = 32


def fr_root_of_unity(order: int) -> int:
    """Primitive `order`-th root of unity in Fr (order must divide 2^32)."""
    if order & (order - 1) or order > (1 << FR_TWO_ADICITY):
        raise ValueError(f"no root of unity of order {order}")
    return pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // order, R)
