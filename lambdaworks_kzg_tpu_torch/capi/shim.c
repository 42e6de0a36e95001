/*
 * C ABI shim: implements the c-kzg-4844 minimal interface (c_kzg_4844.h)
 * by embedding Python and calling lambdaworks_kzg_tpu_torch.capi_adapter,
 * the PyTorch + CUDA port's adapter. No CUDA code is here: the adapter's
 * contexts launch the port's kernels.
 *
 * Every adapter call returns a (ret_code, payload) tuple; this layer only
 * marshals bytes and unpacks, with no exception handling across the
 * boundary.
 *
 * Two ways in. Loaded into a running Python (ctypes), the interpreter
 * exists and the shim only imports the adapter. Linked into a C program,
 * the first call starts an interpreter (Py_InitializeEx), which must find
 * torch and the repository: put both on PYTHONPATH.
 *
 * Threading: all Python calls run under PyGILState_Ensure, and an
 * interpreter the shim started hands the GIL back after its start, so the
 * ABI may be called from any thread once the first call has returned.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdlib.h>
#include <string.h>

#include "c_kzg_4844.h"

typedef struct {
    PyObject *ctx;     /* EIP4844Context */
    size_t blob_size;  /* ctx.n * 32 */
} lw_handle;

static PyObject *g_adapter = NULL; /* module, imported once */

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        /* Py_InitializeEx leaves this thread holding the GIL: release it,
         * so that every call, from any thread, takes it the same way */
        PyEval_SaveThread();
    }
    if (g_adapter == NULL) {
        PyGILState_STATE st = PyGILState_Ensure();
        g_adapter = PyImport_ImportModule("lambdaworks_kzg_tpu_torch.capi_adapter");
        if (g_adapter == NULL) {
            PyErr_Print();
        }
        PyGILState_Release(st);
    }
    return g_adapter != NULL;
}

/* Call adapter.fn(*args); returns the (ret, payload) tuple or NULL. */
static PyObject *call_adapter(const char *fn, PyObject *args) {
    PyObject *f = PyObject_GetAttrString(g_adapter, fn);
    if (f == NULL) {
        Py_XDECREF(args);
        return NULL;
    }
    PyObject *res = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (res == NULL) {
        PyErr_Print();
    }
    return res;
}

static C_KZG_RET unpack_bytes(
    PyObject *res, uint8_t *out, size_t want) {
    if (res == NULL) return C_KZG_ERROR;
    C_KZG_RET ret = (C_KZG_RET)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (ret == C_KZG_OK && out != NULL) {
        PyObject *payload = PyTuple_GetItem(res, 1);
        char *buf = NULL;
        Py_ssize_t len = 0;
        if (PyBytes_AsStringAndSize(payload, &buf, &len) != 0 ||
            (size_t)len != want) {
            Py_DECREF(res);
            return C_KZG_ERROR;
        }
        memcpy(out, buf, want);
    }
    Py_DECREF(res);
    return ret;
}

static C_KZG_RET unpack_bool(PyObject *res, bool *ok) {
    if (res == NULL) return C_KZG_ERROR;
    C_KZG_RET ret = (C_KZG_RET)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (ret == C_KZG_OK) {
        *ok = PyObject_IsTrue(PyTuple_GetItem(res, 1)) == 1;
    }
    Py_DECREF(res);
    return ret;
}

static C_KZG_RET unpack_ctx(PyObject *res, KZGSettings *out) {
    if (res == NULL) return C_KZG_ERROR;
    C_KZG_RET ret = (C_KZG_RET)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (ret != C_KZG_OK) {
        Py_DECREF(res);
        return ret;
    }
    PyObject *ctx = PyTuple_GetItem(res, 1);
    Py_INCREF(ctx);

    PyObject *szres = call_adapter(
        "blob_size", Py_BuildValue("(O)", ctx));
    long bs = szres ? PyLong_AsLong(szres) : -1;
    Py_XDECREF(szres);
    Py_DECREF(res);
    if (bs <= 0) {
        Py_DECREF(ctx);
        return C_KZG_ERROR;
    }

    /* Populate the C-readable blst-layout point tables: callers may walk
     * g1_values / g2_values. */
    void *g1_tab = NULL, *g2_tab = NULL;
    PyObject *tres = call_adapter("blst_tables", Py_BuildValue("(O)", ctx));
    if (tres != NULL && PyLong_AsLong(PyTuple_GetItem(tres, 0)) == C_KZG_OK) {
        PyObject *pair = PyTuple_GetItem(tres, 1);
        char *b1 = NULL, *b2 = NULL;
        Py_ssize_t l1 = 0, l2 = 0;
        if (PyBytes_AsStringAndSize(PyTuple_GetItem(pair, 0), &b1, &l1) == 0 &&
            PyBytes_AsStringAndSize(PyTuple_GetItem(pair, 1), &b2, &l2) == 0) {
            g1_tab = malloc((size_t)l1 > 0 ? (size_t)l1 : 1);
            g2_tab = malloc((size_t)l2 > 0 ? (size_t)l2 : 1);
            if (g1_tab != NULL && g2_tab != NULL) {
                memcpy(g1_tab, b1, (size_t)l1);
                memcpy(g2_tab, b2, (size_t)l2);
            } else {
                free(g1_tab); free(g2_tab);
                g1_tab = g2_tab = NULL;
            }
        }
    }
    Py_XDECREF(tres);
    if (g1_tab == NULL) {
        Py_DECREF(ctx);
        return C_KZG_ERROR;
    }

    lw_handle *h = (lw_handle *)malloc(sizeof(lw_handle));
    if (h == NULL) {
        Py_DECREF(ctx);
        free(g1_tab); free(g2_tab);
        return C_KZG_MALLOC;
    }
    h->ctx = ctx;
    h->blob_size = (size_t)bs;
    out->fs = (void *)h;          /* opaque handle */
    out->g1_values = g1_tab;      /* n1 x blst_p1 (144 B each) */
    out->g2_values = g2_tab;      /* n2 x blst_p2 (288 B each) */
    return C_KZG_OK;
}

static lw_handle *handle_of(const KZGSettings *s) {
    return s ? (lw_handle *)s->fs : NULL;
}

C_KZG_RET load_trusted_setup(
    KZGSettings *out,
    const uint8_t *g1_bytes, size_t n1,
    const uint8_t *g2_bytes, size_t n2) {
    if (out == NULL || (n1 > 0 && g1_bytes == NULL) || (n2 > 0 && g2_bytes == NULL))
        return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "new_context_from_parts",
        Py_BuildValue("(y#ny#n)",
                      (const char *)g1_bytes, (Py_ssize_t)(n1 * 48),
                      (Py_ssize_t)n1,
                      (const char *)g2_bytes, (Py_ssize_t)(n2 * 96),
                      (Py_ssize_t)n2));
    C_KZG_RET ret = unpack_ctx(res, out);
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET load_trusted_setup_file(KZGSettings *out, FILE *in) {
    if (out == NULL || in == NULL) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    /* read the whole file */
    size_t cap = 1 << 20, len = 0;
    char *buf = (char *)malloc(cap);
    if (buf == NULL) return C_KZG_MALLOC;
    size_t got;
    while ((got = fread(buf + len, 1, cap - len, in)) > 0) {
        len += got;
        if (len == cap) {
            cap *= 2;
            char *nb = (char *)realloc(buf, cap);
            if (nb == NULL) { free(buf); return C_KZG_MALLOC; }
            buf = nb;
        }
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "new_context_from_text",
        Py_BuildValue("(y#)", buf, (Py_ssize_t)len));
    free(buf);
    C_KZG_RET ret = unpack_ctx(res, out);
    PyGILState_Release(st);
    return ret;
}

void free_trusted_setup(KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF(h->ctx);
    PyGILState_Release(st);
    free(h);
    free(s->g1_values);
    free(s->g2_values);
    s->fs = NULL;
    s->g1_values = NULL;
    s->g2_values = NULL;
}

C_KZG_RET blob_to_kzg_commitment(
    KZGCommitment *out, const Blob *blob, const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || out == NULL || blob == NULL) return C_KZG_BADARGS;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "blob_to_kzg_commitment",
        Py_BuildValue("(Oy#)", h->ctx, (const char *)blob->bytes,
                      (Py_ssize_t)h->blob_size));
    C_KZG_RET ret = unpack_bytes(res, out->bytes, 48);
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET compute_kzg_proof(
    KZGProof *proof_out, Bytes32 *y_out,
    const Blob *blob, const Bytes32 *z_bytes, const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || proof_out == NULL || y_out == NULL || blob == NULL ||
        z_bytes == NULL)
        return C_KZG_BADARGS;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "compute_kzg_proof",
        Py_BuildValue("(Oy#y#)", h->ctx,
                      (const char *)blob->bytes, (Py_ssize_t)h->blob_size,
                      (const char *)z_bytes->bytes, (Py_ssize_t)32));
    uint8_t tmp[80];
    C_KZG_RET ret = unpack_bytes(res, tmp, 80);
    if (ret == C_KZG_OK) {
        memcpy(proof_out->bytes, tmp, 48);
        memcpy(y_out->bytes, tmp + 48, 32);
    }
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET compute_blob_kzg_proof(
    KZGProof *out, const Blob *blob,
    const Bytes48 *commitment_bytes, const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || out == NULL || blob == NULL || commitment_bytes == NULL)
        return C_KZG_BADARGS;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "compute_blob_kzg_proof",
        Py_BuildValue("(Oy#y#)", h->ctx,
                      (const char *)blob->bytes, (Py_ssize_t)h->blob_size,
                      (const char *)commitment_bytes->bytes, (Py_ssize_t)48));
    C_KZG_RET ret = unpack_bytes(res, out->bytes, 48);
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET verify_kzg_proof(
    bool *ok, const Bytes48 *commitment_bytes, const Bytes32 *z_bytes,
    const Bytes32 *y_bytes, const Bytes48 *proof_bytes,
    const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || ok == NULL || commitment_bytes == NULL || z_bytes == NULL ||
        y_bytes == NULL || proof_bytes == NULL)
        return C_KZG_BADARGS;
    *ok = false;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "verify_kzg_proof",
        Py_BuildValue("(Oy#y#y#y#)", h->ctx,
                      (const char *)commitment_bytes->bytes, (Py_ssize_t)48,
                      (const char *)z_bytes->bytes, (Py_ssize_t)32,
                      (const char *)y_bytes->bytes, (Py_ssize_t)32,
                      (const char *)proof_bytes->bytes, (Py_ssize_t)48));
    C_KZG_RET ret = unpack_bool(res, ok);
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET verify_blob_kzg_proof(
    bool *ok, const Blob *blob, const Bytes48 *commitment_bytes,
    const Bytes48 *proof_bytes, const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || ok == NULL || blob == NULL || commitment_bytes == NULL ||
        proof_bytes == NULL)
        return C_KZG_BADARGS;
    *ok = false;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "verify_blob_kzg_proof",
        Py_BuildValue("(Oy#y#y#)", h->ctx,
                      (const char *)blob->bytes, (Py_ssize_t)h->blob_size,
                      (const char *)commitment_bytes->bytes, (Py_ssize_t)48,
                      (const char *)proof_bytes->bytes, (Py_ssize_t)48));
    C_KZG_RET ret = unpack_bool(res, ok);
    PyGILState_Release(st);
    return ret;
}

C_KZG_RET verify_blob_kzg_proof_batch(
    bool *ok, const Blob *blobs, const Bytes48 *commitments_bytes,
    const Bytes48 *proofs_bytes, size_t n, const KZGSettings *s) {
    lw_handle *h = handle_of(s);
    if (h == NULL || ok == NULL) return C_KZG_BADARGS;
    if (n > 0 && (blobs == NULL || commitments_bytes == NULL ||
                  proofs_bytes == NULL))
        return C_KZG_BADARGS;
    *ok = false;
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *res = call_adapter(
        "verify_blob_kzg_proof_batch",
        Py_BuildValue("(Oy#y#y#n)", h->ctx,
                      (const char *)blobs, (Py_ssize_t)(n * h->blob_size),
                      (const char *)commitments_bytes, (Py_ssize_t)(n * 48),
                      (const char *)proofs_bytes, (Py_ssize_t)(n * 48),
                      (Py_ssize_t)n));
    C_KZG_RET ret = unpack_bool(res, ok);
    PyGILState_Release(st);
    return ret;
}
