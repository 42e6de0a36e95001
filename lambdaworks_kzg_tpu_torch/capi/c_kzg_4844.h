/*
 * c_kzg_4844.h: the C ABI of lambdaworks_kzg_tpu_torch, the PyTorch + CUDA
 * port of the EIP-4844 KZG library.
 *
 * The c-kzg-4844 "minimal interface": the same declarations as the JAX
 * package's capi/lambdaworks_kzg_tpu.h. The implementation (shim.c)
 * embeds Python and calls lambdaworks_kzg_tpu_torch.capi_adapter, whose
 * contexts run on the card (LWKZG_BACKEND=host: on the CPU). Callers link
 * lambdaworks_kzg_tpu_torch/_build/liblambdaworks_kzg_tpu_torch.so and use
 * it exactly like c-kzg-4844, with the repository root and the Python
 * site directory that holds torch on PYTHONPATH.
 */
#ifndef LAMBDAWORKS_KZG_TPU_TORCH_C_KZG_4844_H
#define LAMBDAWORKS_KZG_TPU_TORCH_C_KZG_4844_H

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

#ifdef __cplusplus
extern "C" {
#endif

#ifndef FIELD_ELEMENTS_PER_BLOB
#define FIELD_ELEMENTS_PER_BLOB 4096
#endif

#define BYTES_PER_FIELD_ELEMENT 32
#define BYTES_PER_BLOB (FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT)
#define BYTES_PER_COMMITMENT 48
#define BYTES_PER_PROOF 48

typedef enum {
    C_KZG_OK = 0,      /* success */
    C_KZG_BADARGS,     /* the supplied data is invalid */
    C_KZG_ERROR,       /* internal error */
    C_KZG_MALLOC,      /* allocation failed */
} C_KZG_RET;

typedef struct { uint8_t bytes[32]; } Bytes32;
typedef struct { uint8_t bytes[48]; } Bytes48;
typedef struct { uint8_t bytes[BYTES_PER_BLOB]; } Blob;
typedef Bytes48 KZGCommitment;
typedef Bytes48 KZGProof;

/*
 * blst-shaped point structs, as stored in KZGSettings: coordinates are
 * CANONICAL (non-Montgomery) values, l[0] = most-significant u64,
 * projective z == 1 (infinity: x = y = 0, z encoding value 1). Six limbs.
 */
typedef struct { uint64_t l[6]; } blst_fp;
typedef struct { blst_fp fp[2]; } blst_fp2;
typedef struct { blst_fp x, y, z; } blst_p1;
typedef struct { blst_fp2 x, y, z; } blst_p2;

/*
 * KZGSettings: three pointers.
 *   g1_values: n1 x blst_p1, the setup's G1 points (monomial basis, as
 *              loaded from the file). Callers MAY read this table.
 *   g2_values: n2 x blst_p2, the setup's G2 points. Readable likewise.
 *   fs:        OPAQUE handle owned by this library (the Python context);
 *              non-NULL, and must not be dereferenced or modified.
 * All three are owned by the library; free with free_trusted_setup.
 */
typedef struct {
    void *fs;
    void *g1_values;
    void *g2_values;
} KZGSettings;

C_KZG_RET load_trusted_setup(
    KZGSettings *out,
    const uint8_t *g1_bytes, /* n1 * 48 bytes */
    size_t n1,
    const uint8_t *g2_bytes, /* n2 * 96 bytes */
    size_t n2);

C_KZG_RET load_trusted_setup_file(KZGSettings *out, FILE *in);

void free_trusted_setup(KZGSettings *s);

C_KZG_RET blob_to_kzg_commitment(
    KZGCommitment *out, const Blob *blob, const KZGSettings *s);

C_KZG_RET compute_kzg_proof(
    KZGProof *proof_out,
    Bytes32 *y_out,
    const Blob *blob,
    const Bytes32 *z_bytes,
    const KZGSettings *s);

C_KZG_RET compute_blob_kzg_proof(
    KZGProof *out,
    const Blob *blob,
    const Bytes48 *commitment_bytes,
    const KZGSettings *s);

C_KZG_RET verify_kzg_proof(
    bool *ok,
    const Bytes48 *commitment_bytes,
    const Bytes32 *z_bytes,
    const Bytes32 *y_bytes,
    const Bytes48 *proof_bytes,
    const KZGSettings *s);

C_KZG_RET verify_blob_kzg_proof(
    bool *ok,
    const Blob *blob,
    const Bytes48 *commitment_bytes,
    const Bytes48 *proof_bytes,
    const KZGSettings *s);

C_KZG_RET verify_blob_kzg_proof_batch(
    bool *ok,
    const Blob *blobs,
    const Bytes48 *commitments_bytes,
    const Bytes48 *proofs_bytes,
    size_t n,
    const KZGSettings *s);

#ifdef __cplusplus
}
#endif

#endif /* LAMBDAWORKS_KZG_TPU_TORCH_C_KZG_4844_H */
