/* Native control-plane hot path.
 *
 * Reference: the compiled Cython/C++ submit/receive path
 * (python/ray/_raylet.pyx:3996 submit_task, src/ray/core_worker/
 * core_worker.cc:2149) and the hand-rolled protobuf encoding of the hot
 * RPCs (src/ray/protobuf/). ray_tpu_torch's control plane frames are Python
 * tuples; this module gives the two hot shapes (task/actor CALL and its
 * REPLY), their batch envelope, readiness pushes, and the worker's
 * task_done report a typed binary wire format encoded/decoded in C —
 * no pickle on the steady-state path — plus C implementations of the
 * per-message loops that dominate submit/wait in profiles:
 *
 *   encode(obj)        -> bytes | None (unsupported shape: use pickle)
 *   decode(buf)        -> the tuple/list structure pickle would return
 *   return_oids(tid,n) -> list of n return-object ids (12B prefix+u32)
 *   wait_partition(refs, ready_set, num_returns) -> (ready, rest)|None
 *
 * Wire format (little-endian), payload position 0 is the magic byte
 * 0xF1 — pickle protocol 2+ payloads start with 0x80, so a receiver
 * can route on the first byte with no framing change:
 *
 *   frame   := 0xF1 kind body
 *   kind    := 1 CALL | 2 REPLY | 3 BATCH | 4 RDY
 *   CALL    := u32 req_id  bstr tid  obytes fid  ostr method
 *              bstr args  u32 nret  obytes aid  ostr cgroup
 *   REPLY   := u32 req_id  obytes error  u16 nresults result*
 *   result  := obytes inline  ostr segment  u64 size  u16 nchild bstr*
 *   BATCH   := u32 count elem*          ("B", [...]) envelope
 *   elem    := 0x01 frame-body-with-kind | 0x00 u32 len pickle-bytes
 *   RDY     := u16 count bstr*          ("RDY", (oid,...)) push
 *   bstr    := u32 len bytes            obytes := 0x00 | 0x01 bstr
 *   ostr    := 0x00 | 0x01 u32 len utf8
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define MAGIC 0xF1
#define K_CALL 1
#define K_REPLY 2
#define K_BATCH 3
#define K_RDY 4

/* ------------------------------------------------------------------ buf */

typedef struct {
    char *p;
    Py_ssize_t len, cap;
} Buf;

static int buf_init(Buf *b, Py_ssize_t cap) {
    b->p = PyMem_Malloc(cap);
    if (!b->p) return -1;
    b->len = 0;
    b->cap = cap;
    return 0;
}

static int buf_reserve(Buf *b, Py_ssize_t extra) {
    if (b->len + extra <= b->cap) return 0;
    Py_ssize_t cap = b->cap * 2;
    while (cap < b->len + extra) cap *= 2;
    char *np = PyMem_Realloc(b->p, cap);
    if (!np) return -1;
    b->p = np;
    b->cap = cap;
    return 0;
}

static int buf_u8(Buf *b, uint8_t v) {
    if (buf_reserve(b, 1) < 0) return -1;
    b->p[b->len++] = (char)v;
    return 0;
}

static int buf_u16(Buf *b, uint16_t v) {
    if (buf_reserve(b, 2) < 0) return -1;
    memcpy(b->p + b->len, &v, 2);
    b->len += 2;
    return 0;
}

static int buf_u32(Buf *b, uint32_t v) {
    if (buf_reserve(b, 4) < 0) return -1;
    memcpy(b->p + b->len, &v, 4);
    b->len += 4;
    return 0;
}

static int buf_u64(Buf *b, uint64_t v) {
    if (buf_reserve(b, 8) < 0) return -1;
    memcpy(b->p + b->len, &v, 8);
    b->len += 8;
    return 0;
}

static int buf_raw(Buf *b, const char *src, Py_ssize_t n) {
    if (buf_reserve(b, n) < 0) return -1;
    memcpy(b->p + b->len, src, n);
    b->len += n;
    return 0;
}

/* bytes with u32 length prefix; -1 on overflow/alloc, -2 wrong type */
static int buf_bstr(Buf *b, PyObject *o) {
    char *s;
    Py_ssize_t n;
    if (!PyBytes_Check(o)) return -2;
    s = PyBytes_AS_STRING(o);
    n = PyBytes_GET_SIZE(o);
    if (n > UINT32_MAX) return -2;
    if (buf_u32(b, (uint32_t)n) < 0) return -1;
    return buf_raw(b, s, n);
}

static int buf_obytes(Buf *b, PyObject *o) {
    if (o == Py_None) return buf_u8(b, 0);
    if (buf_u8(b, 1) < 0) return -1;
    return buf_bstr(b, o);
}

static int buf_ostr(Buf *b, PyObject *o) {
    Py_ssize_t n;
    const char *s;
    if (o == Py_None) return buf_u8(b, 0);
    if (!PyUnicode_Check(o)) return -2;
    s = PyUnicode_AsUTF8AndSize(o, &n);
    if (!s || n > UINT32_MAX) return -2;
    if (buf_u8(b, 1) < 0 || buf_u32(b, (uint32_t)n) < 0) return -1;
    return buf_raw(b, s, n);
}

/* ---------------------------------------------------------------- encode */

/* Returns 0 ok, -2 shape-unsupported (no exception), -1 error (exc set) */
static int enc_call(Buf *b, PyObject *t) {
    long req_id, nret;
    PyObject *o;
    if (PyTuple_GET_SIZE(t) != 9) return -2;
    o = PyTuple_GET_ITEM(t, 1);
    if (!PyLong_Check(o)) return -2;
    req_id = PyLong_AsLong(o);
    if (req_id < 0 || req_id > UINT32_MAX) return -2;
    o = PyTuple_GET_ITEM(t, 6);
    if (!PyLong_Check(o)) return -2;
    nret = PyLong_AsLong(o);
    if (nret < 0 || nret > UINT32_MAX) return -2;
    if (buf_u8(b, K_CALL) < 0 || buf_u32(b, (uint32_t)req_id) < 0) return -1;
    int r;
    if ((r = buf_bstr(b, PyTuple_GET_ITEM(t, 2))) != 0) return r;   /* tid */
    if ((r = buf_obytes(b, PyTuple_GET_ITEM(t, 3))) != 0) return r; /* fid */
    if ((r = buf_ostr(b, PyTuple_GET_ITEM(t, 4))) != 0) return r;   /* method */
    if ((r = buf_bstr(b, PyTuple_GET_ITEM(t, 5))) != 0) return r;   /* args */
    if (buf_u32(b, (uint32_t)nret) < 0) return -1;
    if ((r = buf_obytes(b, PyTuple_GET_ITEM(t, 7))) != 0) return r; /* aid */
    if ((r = buf_ostr(b, PyTuple_GET_ITEM(t, 8))) != 0) return r;   /* cg */
    return 0;
}

static int enc_reply(Buf *b, PyObject *t) {
    long req_id;
    PyObject *o, *results;
    Py_ssize_t n, i;
    if (PyTuple_GET_SIZE(t) != 4) return -2;
    o = PyTuple_GET_ITEM(t, 1);
    if (!PyLong_Check(o)) return -2;
    req_id = PyLong_AsLong(o);
    if (req_id < 0 || req_id > UINT32_MAX) return -2;
    results = PyTuple_GET_ITEM(t, 3);
    /* error replies carry results=None — encode as zero results (the
     * receiver checks the error field first); rejecting None silently
     * pushed every error reply onto the pickle fallback */
    if (results == Py_None) {
        if (buf_u8(b, K_REPLY) < 0 || buf_u32(b, (uint32_t)req_id) < 0)
            return -1;
        int r0;
        if ((r0 = buf_obytes(b, PyTuple_GET_ITEM(t, 2))) != 0) return r0;
        return buf_u16(b, 0) < 0 ? -1 : 0;
    }
    if (!PyList_Check(results)) return -2;
    n = PyList_GET_SIZE(results);
    if (n > UINT16_MAX) return -2;
    if (buf_u8(b, K_REPLY) < 0 || buf_u32(b, (uint32_t)req_id) < 0) return -1;
    int r;
    if ((r = buf_obytes(b, PyTuple_GET_ITEM(t, 2))) != 0) return r; /* err */
    if (buf_u16(b, (uint16_t)n) < 0) return -1;
    for (i = 0; i < n; i++) {
        PyObject *res = PyList_GET_ITEM(results, i);
        PyObject *size, *children;
        Py_ssize_t nc, j;
        if (!PyTuple_Check(res) || PyTuple_GET_SIZE(res) != 4) return -2;
        if ((r = buf_obytes(b, PyTuple_GET_ITEM(res, 0))) != 0) return r;
        if ((r = buf_ostr(b, PyTuple_GET_ITEM(res, 1))) != 0) return r;
        size = PyTuple_GET_ITEM(res, 2);
        if (!PyLong_Check(size)) return -2;
        {
            unsigned long long sz = PyLong_AsUnsignedLongLong(size);
            if (sz == (unsigned long long)-1 && PyErr_Occurred()) {
                PyErr_Clear();
                return -2;
            }
            if (buf_u64(b, (uint64_t)sz) < 0) return -1;
        }
        children = PyTuple_GET_ITEM(res, 3);
        if (children == Py_None) {
            /* the common case: no child refs captured in the result —
             * must NOT fall back to pickle (it did until round 5: every
             * childless direct reply silently paid the pickle path) */
            if (buf_u16(b, 0) < 0) return -1;
        } else if (PyTuple_Check(children)) {
            nc = PyTuple_GET_SIZE(children);
            if (nc > UINT16_MAX) return -2;
            if (buf_u16(b, (uint16_t)nc) < 0) return -1;
            for (j = 0; j < nc; j++)
                if ((r = buf_bstr(b, PyTuple_GET_ITEM(children, j))) != 0)
                    return r;
        } else if (PyList_Check(children)) {
            nc = PyList_GET_SIZE(children);
            if (nc > UINT16_MAX) return -2;
            if (buf_u16(b, (uint16_t)nc) < 0) return -1;
            for (j = 0; j < nc; j++)
                if ((r = buf_bstr(b, PyList_GET_ITEM(children, j))) != 0)
                    return r;
        } else {
            return -2;
        }
    }
    return 0;
}

static int enc_rdy(Buf *b, PyObject *t) {
    PyObject *ids;
    Py_ssize_t n, i;
    int r;
    if (PyTuple_GET_SIZE(t) != 2) return -2;
    ids = PyTuple_GET_ITEM(t, 1);
    if (PyTuple_Check(ids)) {
        n = PyTuple_GET_SIZE(ids);
        if (n > UINT16_MAX) return -2;
        if (buf_u8(b, K_RDY) < 0 || buf_u16(b, (uint16_t)n) < 0) return -1;
        for (i = 0; i < n; i++)
            if ((r = buf_bstr(b, PyTuple_GET_ITEM(ids, i))) != 0) return r;
        return 0;
    }
    if (PyList_Check(ids)) {
        n = PyList_GET_SIZE(ids);
        if (n > UINT16_MAX) return -2;
        if (buf_u8(b, K_RDY) < 0 || buf_u16(b, (uint16_t)n) < 0) return -1;
        for (i = 0; i < n; i++)
            if ((r = buf_bstr(b, PyList_GET_ITEM(ids, i))) != 0) return r;
        return 0;
    }
    return -2;
}

static PyObject *g_pickle_dumps;  /* pickle.dumps */
static PyObject *g_pickle_loads;  /* pickle.loads */
static PyObject *g_proto5;        /* int 5 */

/* one frame body (with kind byte), no magic. */
static int enc_frame(Buf *b, PyObject *obj) {
    PyObject *op;
    if (!PyTuple_Check(obj) || PyTuple_GET_SIZE(obj) < 2) return -2;
    op = PyTuple_GET_ITEM(obj, 0);
    if (PyLong_Check(op)) {
        long k = PyLong_AsLong(op);
        if (k == K_CALL) return enc_call(b, obj);
        if (k == K_REPLY) return enc_reply(b, obj);
        return -2;
    }
    if (PyUnicode_Check(op)) {
        if (PyUnicode_CompareWithASCIIString(op, "RDY") == 0)
            return enc_rdy(b, obj);
    }
    return -2;
}

static int enc_batch(Buf *b, PyObject *t) {
    PyObject *list;
    Py_ssize_t n, i;
    if (PyTuple_GET_SIZE(t) != 2) return -2;
    list = PyTuple_GET_ITEM(t, 1);
    if (!PyList_Check(list)) return -2;
    n = PyList_GET_SIZE(list);
    if (n > UINT32_MAX) return -2;
    if (buf_u8(b, K_BATCH) < 0 || buf_u32(b, (uint32_t)n) < 0) return -1;
    for (i = 0; i < n; i++) {
        PyObject *el = PyList_GET_ITEM(list, i);
        Py_ssize_t mark = b->len;
        if (buf_u8(b, 1) < 0) return -1;
        int r = enc_frame(b, el);
        if (r == 0) continue;
        if (r == -1) return -1;
        /* unsupported element: rewind, embed pickled bytes */
        b->len = mark;
        {
            PyObject *pk = PyObject_CallFunctionObjArgs(
                g_pickle_dumps, el, g_proto5, NULL);
            if (!pk) return -1;
            if (buf_u8(b, 0) < 0 || buf_bstr(b, pk) != 0) {
                Py_DECREF(pk);
                return -1;
            }
            Py_DECREF(pk);
        }
    }
    return 0;
}

static PyObject *py_encode(PyObject *self, PyObject *obj) {
    Buf b;
    int r;
    (void)self;
    if (!PyTuple_Check(obj) || PyTuple_GET_SIZE(obj) < 2) Py_RETURN_NONE;
    if (buf_init(&b, 256) < 0) return PyErr_NoMemory();
    b.p[b.len++] = (char)(unsigned char)MAGIC;
    {
        PyObject *op = PyTuple_GET_ITEM(obj, 0);
        if (PyUnicode_Check(op) &&
            PyUnicode_CompareWithASCIIString(op, "B") == 0) {
            r = enc_batch(&b, obj);
        } else {
            r = enc_frame(&b, obj);
        }
    }
    if (r == -2) {
        PyMem_Free(b.p);
        Py_RETURN_NONE;
    }
    if (r == -1) {
        PyMem_Free(b.p);
        if (!PyErr_Occurred()) PyErr_NoMemory();
        return NULL;
    }
    {
        PyObject *out = PyBytes_FromStringAndSize(b.p, b.len);
        PyMem_Free(b.p);
        return out;
    }
}

/* ---------------------------------------------------------------- decode */

typedef struct {
    const char *p;
    Py_ssize_t len, off;
} Rd;

static int rd_u8(Rd *r, uint8_t *v) {
    if (r->off + 1 > r->len) return -1;
    *v = (uint8_t)r->p[r->off++];
    return 0;
}

static int rd_u16(Rd *r, uint16_t *v) {
    if (r->off + 2 > r->len) return -1;
    memcpy(v, r->p + r->off, 2);
    r->off += 2;
    return 0;
}

static int rd_u32(Rd *r, uint32_t *v) {
    if (r->off + 4 > r->len) return -1;
    memcpy(v, r->p + r->off, 4);
    r->off += 4;
    return 0;
}

static int rd_u64(Rd *r, uint64_t *v) {
    if (r->off + 8 > r->len) return -1;
    memcpy(v, r->p + r->off, 8);
    r->off += 8;
    return 0;
}

static PyObject *rd_bstr(Rd *r) {
    uint32_t n;
    if (rd_u32(r, &n) < 0 || r->off + (Py_ssize_t)n > r->len) {
        PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
        return NULL;
    }
    {
        PyObject *o = PyBytes_FromStringAndSize(r->p + r->off, n);
        r->off += n;
        return o;
    }
}

static PyObject *rd_obytes(Rd *r) {
    uint8_t f;
    if (rd_u8(r, &f) < 0) {
        PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
        return NULL;
    }
    if (!f) Py_RETURN_NONE;
    return rd_bstr(r);
}

static PyObject *rd_ostr(Rd *r) {
    uint8_t f;
    uint32_t n;
    if (rd_u8(r, &f) < 0) goto trunc;
    if (!f) Py_RETURN_NONE;
    if (rd_u32(r, &n) < 0 || r->off + (Py_ssize_t)n > r->len) goto trunc;
    {
        PyObject *o = PyUnicode_DecodeUTF8(r->p + r->off, n, NULL);
        r->off += n;
        return o;
    }
trunc:
    PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
    return NULL;
}

static PyObject *dec_frame(Rd *r);

static PyObject *dec_call(Rd *r) {
    uint32_t req_id, nret;
    PyObject *tid = NULL, *fid = NULL, *meth = NULL, *args = NULL;
    PyObject *aid = NULL, *cg = NULL, *out = NULL;
    if (rd_u32(r, &req_id) < 0) goto trunc;
    if (!(tid = rd_bstr(r))) goto fail;
    if (!(fid = rd_obytes(r))) goto fail;
    if (!(meth = rd_ostr(r))) goto fail;
    if (!(args = rd_bstr(r))) goto fail;
    if (rd_u32(r, &nret) < 0) goto trunc;
    if (!(aid = rd_obytes(r))) goto fail;
    if (!(cg = rd_ostr(r))) goto fail;
    out = Py_BuildValue("(lNNNNlNN)", (long)K_CALL, tid,
                        fid, meth, args, (long)nret, aid, cg);
    /* Py_BuildValue 'N' steals; wrap req_id back in by rebuilding: */
    if (out) {
        PyObject *rid = PyLong_FromUnsignedLong(req_id);
        if (!rid) {
            Py_DECREF(out);
            return NULL;
        }
        /* tuple layout: (1, req_id, tid, fid, method, args, nret, aid, cg) */
        PyObject *full = PyTuple_New(9);
        if (!full) {
            Py_DECREF(out);
            Py_DECREF(rid);
            return NULL;
        }
        PyTuple_SET_ITEM(full, 0, PyLong_FromLong(K_CALL));
        PyTuple_SET_ITEM(full, 1, rid);
        {
            int i;
            for (i = 1; i < 8; i++) {
                PyObject *it = PyTuple_GET_ITEM(out, i);
                Py_INCREF(it);
                PyTuple_SET_ITEM(full, i + 1, it);
            }
        }
        Py_DECREF(out);
        return full;
    }
    return NULL;
trunc:
    PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
fail:
    Py_XDECREF(tid);
    Py_XDECREF(fid);
    Py_XDECREF(meth);
    Py_XDECREF(args);
    Py_XDECREF(aid);
    Py_XDECREF(cg);
    return NULL;
}

static PyObject *dec_reply(Rd *r) {
    uint32_t req_id;
    uint16_t n, i;
    PyObject *err = NULL, *results = NULL, *out;
    if (rd_u32(r, &req_id) < 0) goto trunc;
    if (!(err = rd_obytes(r))) goto fail;
    if (rd_u16(r, &n) < 0) goto trunc;
    results = PyList_New(n);
    if (!results) goto fail;
    for (i = 0; i < n; i++) {
        PyObject *inl = NULL, *seg = NULL, *children = NULL, *res;
        uint64_t size;
        uint16_t nc, j;
        if (!(inl = rd_obytes(r))) goto fail;
        if (!(seg = rd_ostr(r))) {
            Py_DECREF(inl);
            goto fail;
        }
        if (rd_u64(r, &size) < 0 || rd_u16(r, &nc) < 0) {
            Py_DECREF(inl);
            Py_DECREF(seg);
            goto trunc;
        }
        children = PyTuple_New(nc);
        if (!children) {
            Py_DECREF(inl);
            Py_DECREF(seg);
            goto fail;
        }
        for (j = 0; j < nc; j++) {
            PyObject *c = rd_bstr(r);
            if (!c) {
                Py_DECREF(inl);
                Py_DECREF(seg);
                Py_DECREF(children);
                goto fail;
            }
            PyTuple_SET_ITEM(children, j, c);
        }
        res = PyTuple_New(4);
        if (!res) {
            Py_DECREF(inl);
            Py_DECREF(seg);
            Py_DECREF(children);
            goto fail;
        }
        PyTuple_SET_ITEM(res, 0, inl);
        PyTuple_SET_ITEM(res, 1, seg);
        PyTuple_SET_ITEM(res, 2, PyLong_FromUnsignedLongLong(size));
        PyTuple_SET_ITEM(res, 3, children);
        PyList_SET_ITEM(results, i, res);
    }
    out = PyTuple_New(4);
    if (!out) goto fail;
    PyTuple_SET_ITEM(out, 0, PyLong_FromLong(K_REPLY));
    PyTuple_SET_ITEM(out, 1, PyLong_FromUnsignedLong(req_id));
    PyTuple_SET_ITEM(out, 2, err);
    PyTuple_SET_ITEM(out, 3, results);
    return out;
trunc:
    PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
fail:
    Py_XDECREF(err);
    Py_XDECREF(results);
    return NULL;
}

static PyObject *dec_rdy(Rd *r) {
    uint16_t n, i;
    PyObject *ids, *out;
    if (rd_u16(r, &n) < 0) {
        PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
        return NULL;
    }
    ids = PyTuple_New(n);
    if (!ids) return NULL;
    for (i = 0; i < n; i++) {
        PyObject *o = rd_bstr(r);
        if (!o) {
            Py_DECREF(ids);
            return NULL;
        }
        PyTuple_SET_ITEM(ids, i, o);
    }
    out = Py_BuildValue("(sN)", "RDY", ids);
    return out;
}

static PyObject *dec_batch(Rd *r) {
    uint32_t n, i;
    PyObject *list, *out;
    if (rd_u32(r, &n) < 0) {
        PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
        return NULL;
    }
    list = PyList_New(n);
    if (!list) return NULL;
    for (i = 0; i < n; i++) {
        uint8_t fast;
        PyObject *el;
        if (rd_u8(r, &fast) < 0) {
            Py_DECREF(list);
            PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
            return NULL;
        }
        if (fast) {
            el = dec_frame(r);
        } else {
            PyObject *pk = rd_bstr(r);
            if (!pk) {
                Py_DECREF(list);
                return NULL;
            }
            el = PyObject_CallFunctionObjArgs(g_pickle_loads, pk, NULL);
            Py_DECREF(pk);
        }
        if (!el) {
            Py_DECREF(list);
            return NULL;
        }
        PyList_SET_ITEM(list, i, el);
    }
    out = Py_BuildValue("(sN)", "B", list);
    return out;
}

static PyObject *dec_frame(Rd *r) {
    uint8_t kind;
    if (rd_u8(r, &kind) < 0) {
        PyErr_SetString(PyExc_ValueError, "fastpath: truncated frame");
        return NULL;
    }
    switch (kind) {
    case K_CALL:
        return dec_call(r);
    case K_REPLY:
        return dec_reply(r);
    case K_BATCH:
        return dec_batch(r);
    case K_RDY:
        return dec_rdy(r);
    default:
        PyErr_Format(PyExc_ValueError, "fastpath: bad frame kind %d", kind);
        return NULL;
    }
}

static PyObject *py_decode(PyObject *self, PyObject *arg) {
    Py_buffer view;
    Rd r;
    uint8_t magic;
    PyObject *out;
    (void)self;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    r.p = (const char *)view.buf;
    r.len = view.len;
    r.off = 0;
    if (rd_u8(&r, &magic) < 0 || magic != MAGIC) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "fastpath: bad magic");
        return NULL;
    }
    out = dec_frame(&r);
    PyBuffer_Release(&view);
    return out;
}

/* -------------------------------------------------------- return_oids
 * ObjectID.bytes_for_return: 12-byte task-id prefix + u32 LE index.
 * (ids.py bytes_for_return; reference: id.h ObjectID::ForTaskReturn.)
 */
static PyObject *py_return_oids(PyObject *self, PyObject *args) {
    const char *tid;
    Py_ssize_t tid_len;
    long n, i;
    PyObject *list;
    char tmp[16];
    (void)self;
    if (!PyArg_ParseTuple(args, "y#l", &tid, &tid_len, &n)) return NULL;
    if (tid_len < 12) {
        PyErr_SetString(PyExc_ValueError, "task id too short");
        return NULL;
    }
    list = PyList_New(n);
    if (!list) return NULL;
    memcpy(tmp, tid, 12);
    for (i = 0; i < n; i++) {
        uint32_t idx = (uint32_t)i;
        PyObject *o;
        memcpy(tmp + 12, &idx, 4);
        o = PyBytes_FromStringAndSize(tmp, 16);
        if (!o) {
            Py_DECREF(list);
            return NULL;
        }
        PyList_SET_ITEM(list, i, o);
    }
    return list;
}

/* ------------------------------------------------------ wait_partition
 * The drain-by-wait hot loop: split refs into (ready, rest) against the
 * client's ready-set, reading ref._id._bytes without interpreter
 * dispatch. Returns None when fewer than num_returns are ready (caller
 * parks on the condvar).
 */
static PyObject *s_id;     /* "_id" */
static PyObject *s_bytes;  /* "_bytes" */

static PyObject *py_wait_partition(PyObject *self, PyObject *args) {
    PyObject *refs, *ready_set;
    long num_returns;
    PyObject *seq = NULL, *ready = NULL, *rest = NULL, *out = NULL;
    Py_ssize_t n, i;
    long nready = 0;
    (void)self;
    if (!PyArg_ParseTuple(args, "OOl", &refs, &ready_set, &num_returns))
        return NULL;
    seq = PySequence_Fast(refs, "refs must be a sequence");
    if (!seq) return NULL;
    n = PySequence_Fast_GET_SIZE(seq);
    ready = PyList_New(0);
    rest = PyList_New(0);
    if (!ready || !rest) goto fail;
    for (i = 0; i < n; i++) {
        PyObject *ref = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *idobj, *idbytes;
        int hit = 0;
        idobj = PyObject_GetAttr(ref, s_id);
        if (!idobj) goto fail;
        idbytes = PyObject_GetAttr(idobj, s_bytes);
        Py_DECREF(idobj);
        if (!idbytes) goto fail;
        if (nready < num_returns) {
            hit = PySet_Contains(ready_set, idbytes);
            if (hit < 0) {
                Py_DECREF(idbytes);
                goto fail;
            }
        }
        Py_DECREF(idbytes);
        if (hit) {
            if (PyList_Append(ready, ref) < 0) goto fail;
            nready++;
        } else {
            if (PyList_Append(rest, ref) < 0) goto fail;
        }
    }
    if (nready < num_returns) {
        Py_DECREF(ready);
        Py_DECREF(rest);
        Py_DECREF(seq);
        Py_RETURN_NONE;
    }
    out = PyTuple_New(2);
    if (!out) goto fail;
    PyTuple_SET_ITEM(out, 0, ready);
    PyTuple_SET_ITEM(out, 1, rest);
    Py_DECREF(seq);
    return out;
fail:
    Py_XDECREF(ready);
    Py_XDECREF(rest);
    Py_XDECREF(seq);
    Py_XDECREF(out);
    return NULL;
}

/* ------------------------------------------------------------ module */

static PyMethodDef methods[] = {
    {"encode", py_encode, METH_O,
     "encode(frame) -> bytes | None (None: shape unsupported, pickle it)"},
    {"decode", py_decode, METH_O,
     "decode(buf) -> frame structure (first byte must be the 0xF1 magic)"},
    {"return_oids", py_return_oids, METH_VARARGS,
     "return_oids(task_id, n) -> [oid bytes] (12B prefix + u32 LE index)"},
    {"wait_partition", py_wait_partition, METH_VARARGS,
     "wait_partition(refs, ready_set, num_returns) -> (ready, rest)|None"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastpath",
    "Native control-plane hot path (frame codec, oid gen, wait partition)",
    -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_fastpath(void) {
    PyObject *m, *pickle;
    m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    pickle = PyImport_ImportModule("pickle");
    if (!pickle) return NULL;
    g_pickle_dumps = PyObject_GetAttrString(pickle, "dumps");
    g_pickle_loads = PyObject_GetAttrString(pickle, "loads");
    Py_DECREF(pickle);
    if (!g_pickle_dumps || !g_pickle_loads) return NULL;
    g_proto5 = PyLong_FromLong(5);
    s_id = PyUnicode_InternFromString("_id");
    s_bytes = PyUnicode_InternFromString("_bytes");
    if (!g_proto5 || !s_id || !s_bytes) return NULL;
    return m;
}
