/*
 * Fuzz harnesses for the port's C ABI (c_kzg_4844.h, implemented by
 * lambdaworks_kzg_tpu_torch/_build/liblambdaworks_kzg_tpu_torch.so): the
 * JAX repository's fuzz/fuzz_capi.c aimed at the port.
 *
 * One source, built seven ways by capi.build_fuzz():
 *   -DFUZZ_TARGET=<0..5>  a dedicated harness for one entry point, which
 *                         takes only inputs of its exact size;
 *   no FUZZ_TARGET        the combined harness: the first byte picks the
 *                         entry point, the rest is its input.
 * With -DSTANDALONE_REPLAY it has a main() that feeds every file named on
 * the command line through the harness, with 16 bit flips and 16
 * truncations of each (gcc has no libFuzzer), and exits 1 when a call
 * returned C_KZG_ERROR or C_KZG_MALLOC (an exception other than a clean
 * rejection); without it, it links against libFuzzer (clang
 * -fsanitize=fuzzer) and aborts on such a call.
 *
 * The setup loads once per process. init_once sets LWKZG_BACKEND=host
 * unless the caller's environment sets it (LWKZG_BACKEND=device runs the
 * contexts on the card). The library embeds Python: run the binary with
 * capi.client_env()'s PYTHONPATH.
 *
 * Seed corpora: python -m lambdaworks_kzg_tpu_torch.fuzz.gen_corpus.
 */
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "c_kzg_4844.h"

#ifndef TRUSTED_SETUP_PATH
#define TRUSTED_SETUP_PATH "testdata/trusted_setup_4.txt"
#endif
#ifndef N_FIELD
#define N_FIELD 4
#endif
#define BLOB_BYTES (N_FIELD * 32)
#define BATCH_N 3 /* the batch target fuzzes a fixed item count */

static KZGSettings settings;
static int initialized = 0;

static void init_once(void) {
    if (initialized) return;
    setenv("LWKZG_BACKEND", "host", 0); /* the caller's choice wins */
    FILE *f = fopen(TRUSTED_SETUP_PATH, "r");
    if (f == NULL || load_trusted_setup_file(&settings, f) != C_KZG_OK) {
        fprintf(stderr, "fuzz: failed to load trusted setup %s\n", TRUSTED_SETUP_PATH);
        exit(1);
    }
    fclose(f);
    initialized = 1;
}

static int t_blob_to_kzg_commitment(const uint8_t *data, size_t size) {
    Bytes48 out48;
    if (size != BLOB_BYTES) return -1;
    return blob_to_kzg_commitment(&out48, (const Blob *)data, &settings);
}

static int t_compute_kzg_proof(const uint8_t *data, size_t size) {
    Bytes48 out48;
    Bytes32 out32;
    if (size != BLOB_BYTES + 32) return -1;
    return compute_kzg_proof(&out48, &out32, (const Blob *)data,
                             (const Bytes32 *)(data + BLOB_BYTES), &settings);
}

static int t_compute_blob_kzg_proof(const uint8_t *data, size_t size) {
    Bytes48 out48;
    if (size != BLOB_BYTES + 48) return -1;
    return compute_blob_kzg_proof(&out48, (const Blob *)data,
                                  (const Bytes48 *)(data + BLOB_BYTES), &settings);
}

static int t_verify_kzg_proof(const uint8_t *data, size_t size) {
    bool ok;
    if (size != 48 + 32 + 32 + 48) return -1;
    return verify_kzg_proof(&ok, (const Bytes48 *)data, (const Bytes32 *)(data + 48),
                            (const Bytes32 *)(data + 80), (const Bytes48 *)(data + 112), &settings);
}

static int t_verify_blob_kzg_proof(const uint8_t *data, size_t size) {
    bool ok;
    if (size != BLOB_BYTES + 96) return -1;
    return verify_blob_kzg_proof(&ok, (const Blob *)data, (const Bytes48 *)(data + BLOB_BYTES),
                                 (const Bytes48 *)(data + BLOB_BYTES + 48), &settings);
}

static int t_verify_blob_kzg_proof_batch(const uint8_t *data, size_t size) {
    bool ok;
    if (size != BATCH_N * (BLOB_BYTES + 96)) return -1;
    const uint8_t *cs = data + BATCH_N * BLOB_BYTES;
    const uint8_t *ps = cs + BATCH_N * 48;
    return verify_blob_kzg_proof_batch(&ok, (const Blob *)data, (const Bytes48 *)cs,
                                       (const Bytes48 *)ps, BATCH_N, &settings);
}

static long calls = 0;
#ifdef STANDALONE_REPLAY
static long internal_errors = 0;
#endif

int LLVMFuzzerTestOneInput(const uint8_t *data, size_t size) {
    int ret;
    init_once();
#if defined(FUZZ_TARGET) && FUZZ_TARGET == 0
    ret = t_blob_to_kzg_commitment(data, size);
#elif defined(FUZZ_TARGET) && FUZZ_TARGET == 1
    ret = t_compute_kzg_proof(data, size);
#elif defined(FUZZ_TARGET) && FUZZ_TARGET == 2
    ret = t_compute_blob_kzg_proof(data, size);
#elif defined(FUZZ_TARGET) && FUZZ_TARGET == 3
    ret = t_verify_kzg_proof(data, size);
#elif defined(FUZZ_TARGET) && FUZZ_TARGET == 4
    ret = t_verify_blob_kzg_proof(data, size);
#elif defined(FUZZ_TARGET) && FUZZ_TARGET == 5
    ret = t_verify_blob_kzg_proof_batch(data, size);
#else
    if (size < 1) return 0;
    switch (data[0] % 6) {
    case 0: ret = t_blob_to_kzg_commitment(data + 1, size - 1); break;
    case 1: ret = t_compute_kzg_proof(data + 1, size - 1); break;
    case 2: ret = t_compute_blob_kzg_proof(data + 1, size - 1); break;
    case 3: ret = t_verify_kzg_proof(data + 1, size - 1); break;
    case 4: ret = t_verify_blob_kzg_proof(data + 1, size - 1); break;
    default: ret = t_verify_blob_kzg_proof_batch(data + 1, size - 1); break;
    }
#endif
    if (ret < 0) return 0;
    calls++;
    /* C_KZG_ERROR and C_KZG_MALLOC: an exception other than a clean
     * rejection reached the ABI. A finding: libFuzzer stops on the abort,
     * the replay mode counts it. */
    if (ret >= C_KZG_ERROR) {
#ifdef STANDALONE_REPLAY
        internal_errors++;
#else
        abort();
#endif
    }
    return 0;
}

#ifdef STANDALONE_REPLAY
/* Replay mode: each file argument through the harness, then 16
 * deterministic mutations of it (a bit flip, and a truncation). */
int main(int argc, char **argv) {
    int n = 0;
    for (int i = 1; i < argc; i++) {
        FILE *f = fopen(argv[i], "rb");
        if (!f) continue;
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        uint8_t *buf = (uint8_t *)malloc(sz > 0 ? (size_t)sz : 1);
        if (buf != NULL && fread(buf, 1, (size_t)sz, f) == (size_t)sz) {
            LLVMFuzzerTestOneInput(buf, (size_t)sz);
            for (int k = 0; k < 16 && sz > 0; k++) {
                uint8_t *m = (uint8_t *)malloc((size_t)sz);
                if (m == NULL) break;
                memcpy(m, buf, (size_t)sz);
                m[(k * 2654435761u) % sz] ^= (uint8_t)(1u << (k & 7));
                LLVMFuzzerTestOneInput(m, (size_t)sz);
                LLVMFuzzerTestOneInput(m, (size_t)(sz - 1 - (k % sz)));
                free(m);
            }
            n++;
        }
        free(buf);
        fclose(f);
    }
    fprintf(stderr, "replayed %d corpus files: %ld calls, %ld internal errors\n", n, calls,
            internal_errors);
    return internal_errors ? 1 : 0;
}
#endif
