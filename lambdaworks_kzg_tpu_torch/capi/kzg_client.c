/*
 * kzg_client.c: a small C program over the port's C ABI (c_kzg_4844.h),
 * as an Ethereum client would call it.
 *
 *     kzg_client <trusted_setup.txt> <seed>
 *
 * Loads the setup from a FILE *, commits to a blob made from <seed>,
 * proves the blob against its commitment, verifies the proof, frees the
 * setup and prints
 *
 *     commitment <96 hex digits>
 *     proof <96 hex digits>
 *     verified <0 or 1>
 *
 * It exits 0 when every call returned C_KZG_OK and the proof verified.
 * The blob: element i is the next 31 bytes of a splitmix64 stream seeded
 * with <seed> (each 64-bit word's bytes least significant first), then a
 * zero top byte, so every element is canonical. Build it against the
 * port's library (capi.build_client does) with FIELD_ELEMENTS_PER_BLOB
 * equal to the setup's G1 count, and run it with the repository root and
 * torch's site directory on PYTHONPATH.
 */
#include <stdio.h>
#include <stdlib.h>

#include "c_kzg_4844.h"

static uint64_t sm_state;

static uint64_t splitmix64(void) {
    uint64_t z = (sm_state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

static uint8_t next_byte(void) {
    static uint64_t word;
    static int left = 0;
    if (left == 0) {
        word = splitmix64();
        left = 8;
    }
    uint8_t b = (uint8_t)(word & 0xff);
    word >>= 8;
    left--;
    return b;
}

static void print_hex(const char *label, const uint8_t *bytes, size_t n) {
    printf("%s ", label);
    for (size_t i = 0; i < n; i++) printf("%02x", bytes[i]);
    printf("\n");
}

int main(int argc, char **argv) {
    if (argc != 3) {
        fprintf(stderr, "usage: %s <trusted_setup.txt> <seed>\n", argv[0]);
        return 2;
    }
    sm_state = strtoull(argv[2], NULL, 10);
    Blob *blob = (Blob *)malloc(sizeof(Blob));
    if (blob == NULL) return 3;
    for (size_t i = 0; i < FIELD_ELEMENTS_PER_BLOB; i++) {
        for (int j = 0; j < 31; j++) blob->bytes[32 * i + j] = next_byte();
        blob->bytes[32 * i + 31] = 0;
    }

    FILE *in = fopen(argv[1], "r");
    if (in == NULL) {
        perror(argv[1]);
        return 2;
    }
    KZGSettings settings;
    C_KZG_RET ret = load_trusted_setup_file(&settings, in);
    fclose(in);
    if (ret != C_KZG_OK) {
        fprintf(stderr, "load_trusted_setup_file -> %d\n", (int)ret);
        return 1;
    }

    KZGCommitment commitment;
    KZGProof proof;
    bool ok = false;
    ret = blob_to_kzg_commitment(&commitment, blob, &settings);
    if (ret == C_KZG_OK) ret = compute_blob_kzg_proof(&proof, blob, &commitment, &settings);
    if (ret == C_KZG_OK) ret = verify_blob_kzg_proof(&ok, blob, &commitment, &proof, &settings);
    free_trusted_setup(&settings);
    free(blob);
    if (ret != C_KZG_OK) {
        fprintf(stderr, "an entry point returned %d\n", (int)ret);
        return 1;
    }
    print_hex("commitment", commitment.bytes, sizeof(commitment.bytes));
    print_hex("proof", proof.bytes, sizeof(proof.bytes));
    printf("verified %d\n", ok ? 1 : 0);
    return ok ? 0 : 1;
}
