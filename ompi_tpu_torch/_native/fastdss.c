/* fastdss — CPython-C-API codec for the DSS wire format's common subset.
 *
 * ≈ the reference's compiled opal/dss pack/unpack (dss_pack.c/dss_unpack.c):
 * every shm/tcp frame header and RML control message pays one encode +
 * one decode; the optimized pure-python codec costs ~3.3/3.8 µs per
 * 7-key header, this module ~0.3/0.4 µs.  The ctypes route was measured
 * and rejected (call marshalling exceeded the work saved) — the C API's
 * ~100 ns call overhead is what makes native pay here.
 *
 * Wire format (must stay byte-identical to ompi_tpu_torch/core/dss.py):
 *   [1B tag][payload]; u32 little-endian lengths for var-size payloads.
 * Handled tags: NONE, BOOL, INT64, FLOAT64, STRING, BYTES, LIST, TUPLE,
 * DICT.  Anything else (ndarray, exotic types, out-of-range ints) raises
 * Unsupported and the caller falls back to the python codec; truncated
 * or corrupt input raises ValueError (the wrapper converts to DSSError).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>

#define T_INT64 1
#define T_FLOAT64 2
#define T_STRING 3
#define T_BYTES 4
#define T_BOOL 5
#define T_NONE 6
#define T_LIST 7
#define T_DICT 8
#define T_TUPLE 10

static PyObject *Unsupported;
static PyObject *RingFull;
static PyObject *TooBig;

/* -- growable output buffer -------------------------------------------- */

typedef struct {
    uint8_t *buf;
    Py_ssize_t len;
    Py_ssize_t cap;
} Out;

static int out_reserve(Out *o, Py_ssize_t extra) {
    if (o->len + extra <= o->cap) return 0;
    Py_ssize_t ncap = o->cap ? o->cap * 2 : 256;
    while (ncap < o->len + extra) ncap *= 2;
    uint8_t *nb = (uint8_t *)PyMem_Realloc(o->buf, (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    o->buf = nb;
    o->cap = ncap;
    return 0;
}

static int out_put(Out *o, const void *src, Py_ssize_t n) {
    if (out_reserve(o, n) < 0) return -1;
    memcpy(o->buf + o->len, src, (size_t)n);
    o->len += n;
    return 0;
}

static int out_u8(Out *o, uint8_t b) { return out_put(o, &b, 1); }

static int out_u32(Out *o, uint32_t v) {
    uint8_t le[4] = {(uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                     (uint8_t)(v >> 24)};
    return out_put(o, le, 4);
}

/* -- pack ---------------------------------------------------------------
 * Returns 0 ok, -1 error set.  Unsupported values raise Unsupported —
 * the python wrapper falls back to the general codec for the WHOLE call
 * (wire compatibility: partial native output is discarded). */

static int pack_obj(Out *o, PyObject *v);

static int pack_obj_rec(Out *o, PyObject *v) {
    /* C-stack guard: a deeply nested structure must raise, not segfault
     * (the python codec raises RecursionError for the same input) */
    if (Py_EnterRecursiveCall(" in fastdss pack")) return -1;
    int rc = pack_obj(o, v);
    Py_LeaveRecursiveCall();
    return rc;
}

static int pack_obj(Out *o, PyObject *v) {
    if (v == Py_None) return out_u8(o, T_NONE);
    if (v == Py_True) { uint8_t b[2] = {T_BOOL, 1}; return out_put(o, b, 2); }
    if (v == Py_False) { uint8_t b[2] = {T_BOOL, 0}; return out_put(o, b, 2); }
    if (PyLong_CheckExact(v)) {
        int overflow = 0;
        int64_t x = (int64_t)PyLong_AsLongLongAndOverflow(v, &overflow);
        if (overflow || (x == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            PyErr_SetString(Unsupported, "int out of int64 range");
            return -1;
        }
        uint8_t rec[9];
        rec[0] = T_INT64;
        memcpy(rec + 1, &x, 8); /* little-endian hosts only (x86/arm64) */
        return out_put(o, rec, 9);
    }
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        uint8_t rec[9];
        rec[0] = T_FLOAT64;
        memcpy(rec + 1, &d, 8);
        return out_put(o, rec, 9);
    }
    if (PyUnicode_CheckExact(v)) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(v, &n);
        if (!s) return -1;
        if (n > (Py_ssize_t)0xFFFFFFFF) {
            PyErr_SetString(Unsupported, "string exceeds u32 length");
            return -1;
        }
        if (out_u8(o, T_STRING) < 0 || out_u32(o, (uint32_t)n) < 0)
            return -1;
        return out_put(o, s, n);
    }
    if (PyBytes_CheckExact(v)) {
        Py_ssize_t n = PyBytes_GET_SIZE(v);
        if (n > (Py_ssize_t)0xFFFFFFFF) {
            PyErr_SetString(Unsupported, "bytes exceed u32 length");
            return -1;
        }
        if (out_u8(o, T_BYTES) < 0 || out_u32(o, (uint32_t)n) < 0)
            return -1;
        return out_put(o, PyBytes_AS_STRING(v), n);
    }
    if (PyList_CheckExact(v) || PyTuple_CheckExact(v)) {
        int is_list = PyList_CheckExact(v);
        Py_ssize_t n = is_list ? PyList_GET_SIZE(v) : PyTuple_GET_SIZE(v);
        if (n > (Py_ssize_t)0xFFFFFFFF) {
            PyErr_SetString(Unsupported, "sequence exceeds u32 length");
            return -1;
        }
        if (out_u8(o, is_list ? T_LIST : T_TUPLE) < 0 ||
            out_u32(o, (uint32_t)n) < 0)
            return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *it = is_list ? PyList_GET_ITEM(v, i)
                                   : PyTuple_GET_ITEM(v, i);
            if (pack_obj_rec(o, it) < 0) return -1;
        }
        return 0;
    }
    if (PyDict_CheckExact(v)) {
        Py_ssize_t n = PyDict_GET_SIZE(v);
        if (out_u8(o, T_DICT) < 0 || out_u32(o, (uint32_t)n) < 0) return -1;
        PyObject *key, *val;
        Py_ssize_t pos = 0;
        while (PyDict_Next(v, &pos, &key, &val)) {
            if (pack_obj_rec(o, key) < 0 || pack_obj_rec(o, val) < 0)
                return -1;
        }
        return 0;
    }
    PyErr_Format(Unsupported, "_fastdss_torch cannot pack %s",
                 Py_TYPE(v)->tp_name);
    return -1;
}

static PyObject *fastdss_pack(PyObject *self, PyObject *values) {
    /* values: a tuple of the objects to pack in sequence */
    if (!PyTuple_CheckExact(values)) {
        PyErr_SetString(PyExc_TypeError, "pack expects a tuple");
        return NULL;
    }
    Out o = {NULL, 0, 0};
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(values); i++) {
        if (pack_obj(&o, PyTuple_GET_ITEM(values, i)) < 0) {
            PyMem_Free(o.buf);
            return NULL;
        }
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)o.buf, o.len);
    PyMem_Free(o.buf);
    return out;
}

/* -- unpack ------------------------------------------------------------ */

typedef struct {
    const uint8_t *d;
    Py_ssize_t len;
    Py_ssize_t pos;
} In;

static int need(In *in, Py_ssize_t n) {
    if (in->pos + n > in->len) {
        PyErr_SetString(PyExc_ValueError, "buffer underrun");
        return -1;
    }
    return 0;
}

static uint32_t rd_u32(In *in) {
    const uint8_t *p = in->d + in->pos;
    in->pos += 4;
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static PyObject *unpack_obj(In *in);

static PyObject *unpack_obj_rec(In *in) {
    if (Py_EnterRecursiveCall(" in fastdss unpack")) return NULL;
    PyObject *v = unpack_obj(in);
    Py_LeaveRecursiveCall();
    return v;
}

static PyObject *unpack_obj(In *in) {
    if (need(in, 1) < 0) return NULL;
    uint8_t tag = in->d[in->pos++];
    switch (tag) {
    case T_NONE:
        Py_RETURN_NONE;
    case T_BOOL: {
        if (need(in, 1) < 0) return NULL;
        uint8_t b = in->d[in->pos++];
        if (b) Py_RETURN_TRUE;
        Py_RETURN_FALSE;
    }
    case T_INT64: {
        if (need(in, 8) < 0) return NULL;
        int64_t x;
        memcpy(&x, in->d + in->pos, 8);
        in->pos += 8;
        return PyLong_FromLongLong((long long)x);
    }
    case T_FLOAT64: {
        if (need(in, 8) < 0) return NULL;
        double d;
        memcpy(&d, in->d + in->pos, 8);
        in->pos += 8;
        return PyFloat_FromDouble(d);
    }
    case T_STRING: {
        if (need(in, 4) < 0) return NULL;
        uint32_t n = rd_u32(in);
        if (need(in, (Py_ssize_t)n) < 0) return NULL;
        PyObject *s = PyUnicode_DecodeUTF8(
            (const char *)(in->d + in->pos), (Py_ssize_t)n, NULL);
        in->pos += n;
        return s;
    }
    case T_BYTES: {
        if (need(in, 4) < 0) return NULL;
        uint32_t n = rd_u32(in);
        if (need(in, (Py_ssize_t)n) < 0) return NULL;
        PyObject *b = PyBytes_FromStringAndSize(
            (const char *)(in->d + in->pos), (Py_ssize_t)n);
        in->pos += n;
        return b;
    }
    case T_LIST:
    case T_TUPLE: {
        if (need(in, 4) < 0) return NULL;
        uint32_t n = rd_u32(in);
        /* a hostile length can't exceed the remaining bytes: every item
         * is >= 1 byte, so bound the allocation before trusting it */
        if ((Py_ssize_t)n > in->len - in->pos) {
            PyErr_SetString(PyExc_ValueError, "buffer underrun in list");
            return NULL;
        }
        PyObject *seq = (tag == T_LIST) ? PyList_New((Py_ssize_t)n)
                                        : PyTuple_New((Py_ssize_t)n);
        if (!seq) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *it = unpack_obj_rec(in);
            if (!it) { Py_DECREF(seq); return NULL; }
            if (tag == T_LIST) PyList_SET_ITEM(seq, i, it);
            else PyTuple_SET_ITEM(seq, i, it);
        }
        return seq;
    }
    case T_DICT: {
        if (need(in, 4) < 0) return NULL;
        uint32_t n = rd_u32(in);
        if ((Py_ssize_t)n * 2 > in->len - in->pos) {
            PyErr_SetString(PyExc_ValueError, "buffer underrun in dict");
            return NULL;
        }
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *k = unpack_obj_rec(in);
            if (!k) { Py_DECREF(d); return NULL; }
            PyObject *v = unpack_obj_rec(in);
            if (!v) { Py_DECREF(k); Py_DECREF(d); return NULL; }
            int rc = PyDict_SetItem(d, k, v);
            Py_DECREF(k);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(d); return NULL; }
        }
        return d;
    }
    default:
        /* ndarray or unknown: let the python codec handle the whole call */
        PyErr_Format(Unsupported, "_fastdss_torch cannot unpack tag %d", tag);
        return NULL;
    }
}

static PyObject *fastdss_unpack(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t limit = -1;
    if (!PyArg_ParseTuple(args, "y*|n", &view, &limit)) return NULL;
    In in = {(const uint8_t *)view.buf, view.len, 0};
    PyObject *out = PyList_New(0);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    while (in.pos < in.len &&
           (limit < 0 || PyList_GET_SIZE(out) < limit)) {
        PyObject *v = unpack_obj(&in);
        if (!v) { Py_DECREF(out); PyBuffer_Release(&view); return NULL; }
        int rc = PyList_Append(out, v);
        Py_DECREF(v);
        if (rc < 0) { Py_DECREF(out); PyBuffer_Release(&view); return NULL; }
    }
    PyBuffer_Release(&view);
    return out;
}

/* -- shared-memory atomics (sharedfp/sm, host-side counters) ----------- */

static int atomic_slot(Py_buffer *mm, Py_ssize_t off, uint64_t **slot) {
    if (off < 0 || off % 8 || off + 8 > mm->len) {
        PyErr_SetString(PyExc_ValueError, "bad atomic slot offset");
        return -1;
    }
    *slot = (uint64_t *)((uint8_t *)mm->buf + off);
    return 0;
}

static PyObject *fastdss_atomic_add(PyObject *self, PyObject *args) {
    Py_buffer mm;
    Py_ssize_t off;
    long long delta;
    if (!PyArg_ParseTuple(args, "w*nL", &mm, &off, &delta)) return NULL;
    uint64_t *slot;
    PyObject *res = NULL;
    if (atomic_slot(&mm, off, &slot) == 0) {
        uint64_t old = __atomic_fetch_add(slot, (uint64_t)(int64_t)delta,
                                          __ATOMIC_ACQ_REL);
        res = PyLong_FromUnsignedLongLong(old);
    }
    PyBuffer_Release(&mm);
    return res;
}

static PyObject *fastdss_atomic_load(PyObject *self, PyObject *args) {
    Py_buffer mm;
    Py_ssize_t off;
    if (!PyArg_ParseTuple(args, "w*n", &mm, &off)) return NULL;
    uint64_t *slot;
    PyObject *res = NULL;
    if (atomic_slot(&mm, off, &slot) == 0)
        res = PyLong_FromUnsignedLongLong(
            __atomic_load_n(slot, __ATOMIC_ACQUIRE));
    PyBuffer_Release(&mm);
    return res;
}

static PyObject *fastdss_atomic_store(PyObject *self, PyObject *args) {
    Py_buffer mm;
    Py_ssize_t off;
    unsigned long long v;
    if (!PyArg_ParseTuple(args, "w*nK", &mm, &off, &v)) return NULL;
    uint64_t *slot;
    PyObject *res = NULL;
    if (atomic_slot(&mm, off, &slot) == 0) {
        __atomic_store_n(slot, (uint64_t)v, __ATOMIC_RELEASE);
        res = Py_None;
        Py_INCREF(res);
    }
    PyBuffer_Release(&mm);
    return res;
}

/* -- matching engine ----------------------------------------------------
 * The PML's matching authority in C (≈ ob1's receive matching,
 * pml_ob1_recvfrag.c:143-173, compiled): posted-recv + unexpected queues
 * per communicator, the per-(peer,cid) wire-sequence gate with held
 * out-of-order frames, and wildcard matching with the reserved-tag
 * guard.  Every method MUST be called with the PML lock held — the
 * engine itself takes no locks (it replaces the pure-python structures
 * those same lock-holding code paths used to mutate).
 *
 * Matching results come back as small "action" tuples the caller
 * executes in Python (deliver / CTS / sack / nack / event emission):
 * the protocol stays in Python, only the hot bookkeeping is native.
 */

typedef struct MatchPosted {
    int64_t source, tag;
    PyObject *req;             /* owned */
    Py_buffer buf;             /* valid iff has_buf: posted contiguous dst */
    int has_buf;
    int64_t itemsize;          /* recv element size (status.count) */
    int64_t max_bytes;         /* truncation bound (count·size); -1 = none */
    struct MatchPosted *next;
} MatchPosted;

typedef struct MatchUnex {
    int64_t peer, tag;
    PyObject *hdr;             /* owned dict */
    PyObject *payload;         /* owned bytes */
    struct MatchUnex *next;
} MatchUnex;

typedef struct CidEntry {
    int64_t cid;
    MatchPosted *ph, *pt;      /* posted queue, FIFO */
    MatchUnex *uh, *ut;        /* unexpected queue, arrival order */
    struct CidEntry *next;
} CidEntry;

typedef struct SeqEntry {
    int64_t peer, cid;
    int64_t expect;
    struct SeqEntry *next;
} SeqEntry;

typedef struct {
    PyObject_HEAD
    CidEntry *cids;
    SeqEntry *seqs;
    PyObject *held;            /* {(peer,cid): {seq: (hdr, payload)}} */
} EngineObject;

#define ENG_ANY_SOURCE (-1)    /* ompi_tpu_torch.mpi.constants.ANY_SOURCE */
#define ENG_ANY_TAG (-2)       /* ompi_tpu_torch.mpi.constants.ANY_TAG */

static int eng_matches(int64_t want_src, int64_t want_tag,
                       int64_t peer, int64_t tag) {
    if (want_src != ENG_ANY_SOURCE && want_src != peer) return 0;
    if (want_tag == ENG_ANY_TAG)
        return tag >= 0;   /* wildcard never matches reserved tags */
    return want_tag == tag;
}

static CidEntry *eng_cid(EngineObject *e, int64_t cid, int create) {
    CidEntry *c = e->cids;
    for (; c; c = c->next)
        if (c->cid == cid) return c;
    if (!create) return NULL;
    c = (CidEntry *)PyMem_Calloc(1, sizeof(CidEntry));
    if (!c) { PyErr_NoMemory(); return NULL; }
    c->cid = cid;
    c->next = e->cids;
    e->cids = c;
    return c;
}

static SeqEntry *eng_seq(EngineObject *e, int64_t peer, int64_t cid,
                         int create) {
    SeqEntry *s = e->seqs;
    for (; s; s = s->next)
        if (s->peer == peer && s->cid == cid) return s;
    if (!create) return NULL;
    s = (SeqEntry *)PyMem_Calloc(1, sizeof(SeqEntry));
    if (!s) { PyErr_NoMemory(); return NULL; }
    s->peer = peer;
    s->cid = cid;
    s->next = e->seqs;
    e->seqs = s;
    return s;
}

static void eng_free_posted(MatchPosted *p) {
    if (p->has_buf) PyBuffer_Release(&p->buf);
    Py_XDECREF(p->req);
    PyMem_Free(p);
}

static void eng_free_unex(MatchUnex *u) {
    Py_XDECREF(u->hdr);
    Py_XDECREF(u->payload);
    PyMem_Free(u);
}

static int64_t eng_dict_i64(PyObject *d, const char *key, int64_t dflt,
                            int *found) {
    PyObject *v = PyDict_GetItemString(d, key);   /* borrowed */
    if (found) *found = v != NULL;
    if (!v) return dflt;
    return (int64_t)PyLong_AsLongLong(v);
}

/* payload stored beyond the call must own its bytes (zero-copy self/proc
 * payloads alias the sender's live buffer) */
static PyObject *eng_own_bytes(PyObject *payload) {
    if (PyBytes_CheckExact(payload)) {
        Py_INCREF(payload);
        return payload;
    }
    return PyBytes_FromObject(payload);
}

/* match one in-order data frame; appends one action tuple to `acts`.
 * Returns 0 ok / -1 error. */
static int eng_match_one(EngineObject *e, int64_t peer, PyObject *hdr,
                         PyObject *payload, PyObject *acts) {
    int64_t cid = eng_dict_i64(hdr, "cid", 0, NULL);
    int64_t tag = eng_dict_i64(hdr, "tag", 0, NULL);
    if (PyErr_Occurred()) return -1;
    CidEntry *c = eng_cid(e, cid, 1);
    if (!c) return -1;
    MatchPosted *p = c->ph, *prev = NULL;
    for (; p; prev = p, p = p->next) {
        if (eng_matches(p->source, p->tag, peer, tag)) {
            if (prev) prev->next = p->next; else c->ph = p->next;
            if (c->pt == p) c->pt = prev;
            PyObject *act = Py_BuildValue("(sOLOO)", "match", p->req,
                                          (long long)peer, hdr, payload);
            int rc = act ? PyList_Append(acts, act) : -1;
            Py_XDECREF(act);
            eng_free_posted(p);
            return rc;
        }
    }
    /* no posted match */
    PyObject *sm = PyDict_GetItemString(hdr, "sm");
    if (sm && PyUnicode_CheckExact(sm)
        && PyUnicode_CompareWithASCIIString(sm, "r") == 0) {
        PyObject *act = Py_BuildValue("(sLO)", "rnack", (long long)peer,
                                      hdr);
        int rc = act ? PyList_Append(acts, act) : -1;
        Py_XDECREF(act);
        return rc;
    }
    MatchUnex *u = (MatchUnex *)PyMem_Calloc(1, sizeof(MatchUnex));
    if (!u) { PyErr_NoMemory(); return -1; }
    u->peer = peer;
    u->tag = tag;
    Py_INCREF(hdr);
    u->hdr = hdr;
    u->payload = eng_own_bytes(payload);
    if (!u->payload) { eng_free_unex(u); return -1; }
    if (c->ut) c->ut->next = u; else c->uh = u;
    c->ut = u;
    PyObject *act = Py_BuildValue("(sLO)", "unexpected", (long long)peer,
                                  hdr);
    int rc = act ? PyList_Append(acts, act) : -1;
    Py_XDECREF(act);
    return rc;
}

static PyObject *Engine_post(EngineObject *e, PyObject *args) {
    /* post(cid, source, tag, req, buf_or_None, itemsize, max_bytes)
     *   → None (posted) | (peer, hdr, payload) unexpected hit (removed) */
    long long cid, source, tag, itemsize, max_bytes = -1;
    PyObject *req, *buf;
    if (!PyArg_ParseTuple(args, "LLLOOL|L", &cid, &source, &tag, &req,
                          &buf, &itemsize, &max_bytes))
        return NULL;
    CidEntry *c = eng_cid(e, cid, 1);
    if (!c) return NULL;
    MatchUnex *u = c->uh, *prev = NULL;
    for (; u; prev = u, u = u->next) {
        if (eng_matches(source, tag, u->peer, u->tag)) {
            if (prev) prev->next = u->next; else c->uh = u->next;
            if (c->ut == u) c->ut = prev;
            PyObject *out = Py_BuildValue("(LOO)", (long long)u->peer,
                                          u->hdr, u->payload);
            eng_free_unex(u);
            return out;
        }
    }
    MatchPosted *p = (MatchPosted *)PyMem_Calloc(1, sizeof(MatchPosted));
    if (!p) return PyErr_NoMemory();
    p->source = source;
    p->tag = tag;
    p->itemsize = itemsize > 0 ? itemsize : 1;
    p->max_bytes = max_bytes;
    if (buf != Py_None) {
        if (PyObject_GetBuffer(buf, &p->buf,
                               PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) == 0)
            p->has_buf = 1;
        else
            PyErr_Clear();   /* exotic buffer: deliver via python path */
    }
    Py_INCREF(req);
    p->req = req;
    if (c->pt) c->pt->next = p; else c->ph = p;
    c->pt = p;
    Py_RETURN_NONE;
}

static PyObject *Engine_cancel(EngineObject *e, PyObject *args) {
    /* cancel(cid, req) → True iff the posted entry was removed */
    long long cid;
    PyObject *req;
    if (!PyArg_ParseTuple(args, "LO", &cid, &req)) return NULL;
    CidEntry *c = eng_cid(e, cid, 0);
    if (c) {
        MatchPosted *p = c->ph, *prev = NULL;
        for (; p; prev = p, p = p->next) {
            if (p->req == req) {
                if (prev) prev->next = p->next; else c->ph = p->next;
                if (c->pt == p) c->pt = prev;
                eng_free_posted(p);
                Py_RETURN_TRUE;
            }
        }
    }
    Py_RETURN_FALSE;
}

static PyObject *Engine_iprobe(EngineObject *e, PyObject *args) {
    /* iprobe(cid, source, tag) → None | (peer, hdr)  (not removed) */
    long long cid, source, tag;
    if (!PyArg_ParseTuple(args, "LLL", &cid, &source, &tag)) return NULL;
    CidEntry *c = eng_cid(e, cid, 0);
    if (c) {
        MatchUnex *u = c->uh;
        for (; u; u = u->next)
            if (eng_matches(source, tag, u->peer, u->tag))
                return Py_BuildValue("(LO)", (long long)u->peer, u->hdr);
    }
    Py_RETURN_NONE;
}

static PyObject *Engine_improbe(EngineObject *e, PyObject *args) {
    /* improbe(cid, source, tag) → None | (peer, hdr, payload) (removed —
     * the match-and-detach MPI_Mprobe exists for) */
    long long cid, source, tag;
    if (!PyArg_ParseTuple(args, "LLL", &cid, &source, &tag)) return NULL;
    CidEntry *c = eng_cid(e, cid, 0);
    if (c) {
        MatchUnex *u = c->uh, *prev = NULL;
        for (; u; prev = u, u = u->next) {
            if (eng_matches(source, tag, u->peer, u->tag)) {
                if (prev) prev->next = u->next; else c->uh = u->next;
                if (c->ut == u) c->ut = prev;
                PyObject *out = Py_BuildValue("(LOO)", (long long)u->peer,
                                              u->hdr, u->payload);
                eng_free_unex(u);
                return out;
            }
        }
    }
    Py_RETURN_NONE;
}

static int64_t eng_drain_held(EngineObject *e, int64_t peer, int64_t cid,
                              int64_t nxt, PyObject *acts);

/* run the seq gate for one frame, then match it and any held
 * continuations.  Appends actions; 0 ok / -1 error. */
static int eng_gate_and_match(EngineObject *e, int64_t peer, PyObject *hdr,
                              PyObject *payload, PyObject *acts) {
    int has_seq = 0;
    int64_t seq = eng_dict_i64(hdr, "seq", 0, &has_seq);
    int64_t cid = eng_dict_i64(hdr, "cid", 0, NULL);
    if (PyErr_Occurred()) return -1;
    if (!has_seq)
        return eng_match_one(e, peer, hdr, payload, acts);
    SeqEntry *s = eng_seq(e, peer, cid, 1);
    if (!s) return -1;
    if (seq != s->expect) {
        /* early frame: hold (owning copies) until its turn */
        PyObject *key = Py_BuildValue("(LL)", (long long)peer,
                                      (long long)cid);
        if (!key) return -1;
        PyObject *per = PyDict_GetItem(e->held, key);   /* borrowed */
        if (!per) {
            per = PyDict_New();
            if (!per || PyDict_SetItem(e->held, key, per) < 0) {
                Py_XDECREF(per);
                Py_DECREF(key);
                return -1;
            }
            Py_DECREF(per);   /* held dict keeps it alive */
            per = PyDict_GetItem(e->held, key);
        }
        Py_DECREF(key);
        PyObject *owned = eng_own_bytes(payload);
        if (!owned) return -1;
        PyObject *val = Py_BuildValue("(ON)", hdr, owned);
        if (!val) return -1;
        PyObject *k2 = PyLong_FromLongLong((long long)seq);
        int rc = k2 ? PyDict_SetItem(per, k2, val) : -1;
        Py_XDECREF(k2);
        Py_DECREF(val);
        return rc;
    }
    if (eng_match_one(e, peer, hdr, payload, acts) < 0) return -1;
    int64_t nxt = eng_drain_held(e, peer, cid, seq + 1, acts);
    if (nxt < 0) return -1;
    s->expect = nxt;
    return 0;
}

static PyObject *Engine_incoming(EngineObject *e, PyObject *args) {
    /* incoming(peer, hdr, payload) → [actions]
     * action ∈ ("match", req, peer, hdr, payload)
     *        | ("unexpected", peer, hdr)
     *        | ("rnack", peer, hdr)                                   */
    long long peer;
    PyObject *hdr, *payload;
    if (!PyArg_ParseTuple(args, "LO!O", &peer, &PyDict_Type, &hdr,
                          &payload))
        return NULL;
    PyObject *acts = PyList_New(0);
    if (!acts) return NULL;
    if (eng_gate_and_match(e, peer, hdr, payload, acts) < 0) {
        Py_DECREF(acts);
        return NULL;
    }
    return acts;
}

/* drain held continuations after `expect` advanced past an accepted
 * frame; returns the new expect value or -1 on error */
static int64_t eng_drain_held(EngineObject *e, int64_t peer, int64_t cid,
                              int64_t nxt, PyObject *acts) {
    PyObject *key = Py_BuildValue("(LL)", (long long)peer, (long long)cid);
    if (!key) return -1;
    PyObject *per = PyDict_GetItem(e->held, key);   /* borrowed */
    while (per) {
        PyObject *k2 = PyLong_FromLongLong((long long)nxt);
        if (!k2) { Py_DECREF(key); return -1; }
        PyObject *val = PyDict_GetItem(per, k2);    /* borrowed */
        if (!val) { Py_DECREF(k2); break; }
        Py_INCREF(val);
        PyDict_DelItem(per, k2);
        Py_DECREF(k2);
        int rc = eng_match_one(e, peer, PyTuple_GET_ITEM(val, 0),
                               PyTuple_GET_ITEM(val, 1), acts);
        Py_DECREF(val);
        if (rc < 0) { Py_DECREF(key); return -1; }
        nxt++;
    }
    Py_DECREF(key);
    return nxt;
}

static PyObject *Engine_incoming_fast(EngineObject *e, PyObject *args) {
    /* incoming_fast(peer, tag, cid, seq, payload, dt, elems, shp)
     *   → None: NOT consumed — state untouched; the caller must take
     *     the header-dict path (out-of-order frame, truncation risk,
     *     exotic posted buffer)
     *   | [action, …held actions] where the first action is one of
     *     ("done", req, peer, tag, count, nbytes)   — payload memcpy'd
     *        into the posted contiguous buffer: match+deliver with no
     *        header object at all, or
     *     ("adeliver", req, peer, tag, payload, dt, shp) — matched an
     *        allocate-on-match recv (no posted buffer); python builds
     *        the array, or
     *     ("unexpected", peer, hdr)                 — stored in C (the
     *        header dict is materialized here, once, for later probes).
     *   Caller contract: plain eager standard frames only (no
     *   sm/sid/ep/si), engine called under the PML lock. */
    long long peer, tag, cid, seq, elems;
    Py_buffer pay;
    PyObject *dt, *shp;
    if (!PyArg_ParseTuple(args, "LLLLy*OLO", &peer, &tag, &cid, &seq,
                          &pay, &dt, &elems, &shp))
        return NULL;
    PyObject *result = NULL;
    SeqEntry *s = eng_seq(e, peer, cid, 1);
    if (!s) goto err;
    if (seq != s->expect) goto none;          /* dict path holds it */
    {
        CidEntry *c = eng_cid(e, cid, 1);
        if (!c) goto err;
        MatchPosted *p = c->ph, *prev = NULL;
        for (; p; prev = p, p = p->next)
            if (eng_matches(p->source, p->tag, peer, tag)) break;
        PyObject *acts = NULL, *act = NULL;
        if (p && p->has_buf) {
            if (pay.len > p->buf.len
                || (p->max_bytes >= 0 && pay.len > p->max_bytes))
                goto none;   /* truncation: header path raises properly */
            memcpy(p->buf.buf, pay.buf, (size_t)pay.len);
            act = Py_BuildValue(
                "(sOLLLL)", "done", p->req, (long long)peer,
                (long long)tag, (long long)(pay.len / p->itemsize),
                (long long)pay.len);
        } else if (p) {
            if (p->max_bytes >= 0 && pay.len > p->max_bytes)
                goto none;   /* posted count bound: header path raises */
            PyObject *owned = PyBytes_FromStringAndSize(
                (const char *)pay.buf, pay.len);
            if (!owned) goto err;
            act = Py_BuildValue("(sOLLNOO)", "adeliver", p->req,
                                (long long)peer, (long long)tag, owned,
                                dt, shp);
        } else {
            /* no posted recv: materialize the header dict ONCE and
             * store the frame unexpected, exactly like the dict path */
            PyObject *hdr = Py_BuildValue(
                "{s:s,s:L,s:L,s:L,s:O,s:L,s:O}", "t", "eager",
                "tag", (long long)tag, "cid", (long long)cid,
                "seq", (long long)seq, "dt", dt, "elems", (long long)elems,
                "shp", shp);
            if (!hdr) goto err;
            MatchUnex *u = (MatchUnex *)PyMem_Calloc(1, sizeof(MatchUnex));
            if (!u) { Py_DECREF(hdr); PyErr_NoMemory(); goto err; }
            u->peer = peer;
            u->tag = tag;
            u->hdr = hdr;
            u->payload = PyBytes_FromStringAndSize(
                (const char *)pay.buf, pay.len);
            if (!u->payload) { eng_free_unex(u); goto err; }
            if (c->ut) c->ut->next = u; else c->uh = u;
            c->ut = u;
            act = Py_BuildValue("(sLO)", "unexpected", (long long)peer,
                                hdr);
        }
        if (!act) goto err;
        acts = PyList_New(0);
        if (!acts || PyList_Append(acts, act) < 0) {
            Py_XDECREF(acts);
            Py_DECREF(act);
            goto err;
        }
        Py_DECREF(act);
        if (p) {
            if (prev) prev->next = p->next; else c->ph = p->next;
            if (c->pt == p) c->pt = prev;
            eng_free_posted(p);
        }
        int64_t nxt = eng_drain_held(e, peer, cid, seq + 1, acts);
        if (nxt < 0) { Py_DECREF(acts); goto err; }
        s->expect = nxt;
        result = acts;
    }
    goto out;
none:
    result = Py_None;
    Py_INCREF(result);
    goto out;
err:
    result = NULL;
out:
    PyBuffer_Release(&pay);
    return result;
}

/* -- fused shm-ring drain ----------------------------------------------
 * Decode frames straight out of a mapped SPSC ring (btl_shm layout, see
 * ring_send/ring_recv below) and run them through the matcher in one C
 * call per batch.  The plain-eager hot case copies the payload RING →
 * POSTED USER BUFFER directly (single copy, no intermediate bytes
 * object, no header object).  Declared above the ring helpers it uses.
 */

static void ring_in(const uint8_t *mm, Py_ssize_t cap, Py_ssize_t pos,
                    uint8_t *dst, Py_ssize_t len);

#define RING_HDR 64   /* identical to the ring-framing section below */

/* fast header scan: DSS dict of ONLY the plain-eager keys
 * {t:"eager", tag, cid, seq, dt, elems, shp:[ints]} → scalar fields,
 * no PyObjects.  Returns 1 = fast ok, 0 = not fast (caller builds the
 * dict), -1 = corrupt (ValueError set). */
typedef struct {
    int64_t tag, cid, seq;
    int has_tag, has_cid, has_seq;
} FastHdr;

static Py_ssize_t scan_skip_value(const uint8_t *d, Py_ssize_t len,
                                  Py_ssize_t pos, int *fast_ok) {
    if (pos >= len) return -1;
    uint8_t tag = d[pos++];
    switch (tag) {
    case T_NONE: return pos;
    case T_BOOL: return pos + 1 <= len ? pos + 1 : -1;
    case T_INT64:
    case T_FLOAT64: return pos + 8 <= len ? pos + 8 : -1;
    case T_STRING:
    case T_BYTES: {
        if (pos + 4 > len) return -1;
        uint32_t n = (uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8) |
                     ((uint32_t)d[pos + 2] << 16) |
                     ((uint32_t)d[pos + 3] << 24);
        pos += 4;
        return pos + (Py_ssize_t)n <= len ? pos + (Py_ssize_t)n : -1;
    }
    case T_LIST:
    case T_TUPLE: {
        if (pos + 4 > len) return -1;
        uint32_t n = (uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8) |
                     ((uint32_t)d[pos + 2] << 16) |
                     ((uint32_t)d[pos + 3] << 24);
        pos += 4;
        for (uint32_t i = 0; i < n; i++) {
            if (pos >= len) return -1;
            if (d[pos] != T_INT64) { *fast_ok = 0; /* still skip? no — */
                return -2; }       /* nested non-int: not scannable */
            pos += 9;
            if (pos > len) return -1;
        }
        return pos;
    }
    default:
        return -2;   /* exotic tag: let the full decoder judge it */
    }
}

static int scan_fast_hdr(const uint8_t *d, Py_ssize_t len, FastHdr *out) {
    Py_ssize_t pos = 0;
    int is_eager = 0;
    memset(out, 0, sizeof(*out));
    if (len < 5 || d[pos++] != T_DICT) return 0;
    uint32_t n = (uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8) |
                 ((uint32_t)d[pos + 2] << 16) | ((uint32_t)d[pos + 3] << 24);
    pos += 4;
    for (uint32_t i = 0; i < n; i++) {
        /* key: short string */
        if (pos + 5 > len || d[pos] != T_STRING) return 0;
        uint32_t klen = (uint32_t)d[pos + 1] | ((uint32_t)d[pos + 2] << 8) |
                        ((uint32_t)d[pos + 3] << 16) |
                        ((uint32_t)d[pos + 4] << 24);
        pos += 5;
        if (pos + (Py_ssize_t)klen > len || klen > 8) return 0;
        const char *k = (const char *)(d + pos);
        pos += klen;
        if (klen == 1 && k[0] == 't') {
            /* value must be the string "eager" */
            if (pos + 5 > len || d[pos] != T_STRING) return 0;
            uint32_t vlen = (uint32_t)d[pos + 1] |
                            ((uint32_t)d[pos + 2] << 8) |
                            ((uint32_t)d[pos + 3] << 16) |
                            ((uint32_t)d[pos + 4] << 24);
            pos += 5;
            if (pos + (Py_ssize_t)vlen > len) return 0;
            if (vlen == 5 && memcmp(d + pos, "eager", 5) == 0)
                is_eager = 1;
            else
                return 0;      /* rndv/control: dict path */
            pos += vlen;
        } else if ((klen == 3 && memcmp(k, "tag", 3) == 0) ||
                   (klen == 3 && memcmp(k, "cid", 3) == 0) ||
                   (klen == 3 && memcmp(k, "seq", 3) == 0)) {
            if (pos + 9 > len || d[pos] != T_INT64) return 0;
            int64_t v;
            memcpy(&v, d + pos + 1, 8);
            pos += 9;
            if (k[0] == 't') { out->tag = v; out->has_tag = 1; }
            else if (k[0] == 'c') { out->cid = v; out->has_cid = 1; }
            else { out->seq = v; out->has_seq = 1; }
        } else if ((klen == 2 && memcmp(k, "dt", 2) == 0) ||
                   (klen == 5 && memcmp(k, "elems", 5) == 0) ||
                   (klen == 3 && memcmp(k, "shp", 3) == 0)) {
            int fast_ok = 1;
            Py_ssize_t np_ = scan_skip_value(d, len, pos, &fast_ok);
            if (np_ < 0) return 0;   /* unscannable/odd: dict path */
            pos = np_;
        } else {
            return 0;   /* sm/sid/ep/si/size/unknown: dict path */
        }
    }
    return (is_eager && out->has_tag && out->has_cid && out->has_seq
            && pos == len) ? 1 : 0;
}

static PyObject *Engine_drain_ring(EngineObject *e, PyObject *args) {
    /* drain_ring(peer, mm, tail, limit)
     *   → (new_tail, nframes, actions)
     * Frames with t ∈ {eager, rndv} and no respawn stamps run through
     * the matcher (fast or dict path) — their actions come back for the
     * caller (holding the PML lock) to execute.  Control frames and
     * stamped frames come back as ("frame", hdr, payload) punts the
     * caller feeds to the full _on_frame AFTER releasing the lock (they
     * take the lock themselves; ordering analysis: a ring never mixes
     * incarnations, and control frames are independent state machines).
     * Failure atomicity: the loop COMMITS per frame (engine state,
     * shm tail, actions).  An error on frame k>0 therefore must not
     * throw away the k committed frames' actions — the batch stops and
     * returns them; the caller's NEXT drain call hits the bad frame
     * first (k=0, nothing committed) and only then raises: ValueError
     * on ring corruption (tail NOT advanced past the bad frame),
     * Unsupported when a header needs the python codec.
     */
    long long peer, tail, limit;
    Py_buffer mm;
    if (!PyArg_ParseTuple(args, "Lw*LL", &peer, &mm, &tail, &limit))
        return NULL;
    PyObject *acts = PyList_New(0);
    if (!acts) { PyBuffer_Release(&mm); return NULL; }
    uint8_t *staged = NULL;
    Py_ssize_t staged_cap = 0;
    long long nframes = 0;
    uint8_t *base = (uint8_t *)mm.buf;
    if (mm.len < RING_HDR) {
        PyErr_SetString(PyExc_ValueError, "ring mapping too small");
        goto fail;
    }
    {
        Py_ssize_t cap = (Py_ssize_t)((uint64_t *)base)[2];
        if (cap <= 0 || RING_HDR + cap > mm.len) {
            PyErr_SetString(PyExc_ValueError, "bad ring capacity");
            goto fail;
        }
        while (nframes < limit) {
            uint64_t head = __atomic_load_n((uint64_t *)base,
                                            __ATOMIC_ACQUIRE);
            int64_t avail = (int64_t)(head - (uint64_t)tail);
            if (avail == 0) break;
            if (avail < 8 || avail > cap) {
                PyErr_SetString(PyExc_ValueError, "corrupt ring state");
                goto fail;
            }
            uint32_t lens[2];
            ring_in(base, cap, (Py_ssize_t)tail, (uint8_t *)lens, 8);
            Py_ssize_t total = (Py_ssize_t)lens[0];
            Py_ssize_t hdr_len = (Py_ssize_t)lens[1];
            if (total < hdr_len || 8 + total > avail) {
                PyErr_SetString(PyExc_ValueError, "corrupt ring frame");
                goto fail;
            }
            Py_ssize_t body_off = (Py_ssize_t)((tail + 8) % cap);
            const uint8_t *hdr_bytes;
            int hdr_staged = 0;
            if (body_off + hdr_len <= cap) {
                hdr_bytes = base + RING_HDR + body_off;
            } else {
                if (hdr_len > staged_cap) {
                    uint8_t *ns = (uint8_t *)PyMem_Realloc(staged, hdr_len);
                    if (!ns) { PyErr_NoMemory(); goto fail; }
                    staged = ns;
                    staged_cap = hdr_len;
                }
                ring_in(base, cap, (Py_ssize_t)(tail + 8), staged,
                        hdr_len);
                hdr_bytes = staged;
                hdr_staged = 1;
            }
            Py_ssize_t pay_len = total - hdr_len;
            Py_ssize_t pay_pos = (Py_ssize_t)(tail + 8 + hdr_len);
            FastHdr fh;
            int fast = scan_fast_hdr(hdr_bytes, hdr_len, &fh);
            int consumed = 0;
            if (fast) {
                SeqEntry *s = eng_seq(e, peer, fh.cid, 1);
                if (!s) goto fail;
                if (fh.seq == s->expect) {
                    CidEntry *c = eng_cid(e, fh.cid, 1);
                    if (!c) goto fail;
                    MatchPosted *p = c->ph, *prev = NULL;
                    for (; p; prev = p, p = p->next)
                        if (eng_matches(p->source, p->tag, peer, fh.tag))
                            break;
                    if (p && p->has_buf && pay_len <= p->buf.len
                        && (p->max_bytes < 0 || pay_len <= p->max_bytes)) {
                        /* single copy: ring → posted user buffer */
                        ring_in(base, cap, pay_pos, (uint8_t *)p->buf.buf,
                                pay_len);
                        if (prev) prev->next = p->next;
                        else c->ph = p->next;
                        if (c->pt == p) c->pt = prev;
                        PyObject *act = Py_BuildValue(
                            "(sOLLLL)", "done", p->req, (long long)peer,
                            (long long)fh.tag,
                            (long long)(pay_len / p->itemsize),
                            (long long)pay_len);
                        int rc = act ? PyList_Append(acts, act) : -1;
                        Py_XDECREF(act);
                        eng_free_posted(p);
                        if (rc < 0) goto fail;
                        int64_t nxt = eng_drain_held(e, peer, fh.cid,
                                                     fh.seq + 1, acts);
                        if (nxt < 0) goto fail;
                        s->expect = nxt;
                        consumed = 1;
                    }
                }
            }
            if (!consumed) {
                /* build the dict + payload and run the generic path */
                In in = {hdr_bytes, hdr_len, 0};
                PyObject *hdr = unpack_obj_rec(&in);
                if (!hdr) goto fail;
                if (in.pos != hdr_len) {
                    Py_DECREF(hdr);
                    PyErr_SetString(PyExc_ValueError,
                                    "trailing header bytes");
                    goto fail;
                }
                PyObject *payload = PyBytes_FromStringAndSize(NULL,
                                                              pay_len);
                if (!payload) { Py_DECREF(hdr); goto fail; }
                if (pay_len)
                    ring_in(base, cap, pay_pos,
                            (uint8_t *)PyBytes_AS_STRING(payload),
                            pay_len);
                int is_data = 0;
                if (PyDict_CheckExact(hdr)) {
                    PyObject *t = PyDict_GetItemString(hdr, "t");
                    if (t && PyUnicode_CheckExact(t)
                        && (PyUnicode_CompareWithASCIIString(t, "eager")
                                == 0
                            || PyUnicode_CompareWithASCIIString(t, "rndv")
                                == 0)
                        && !PyDict_GetItemString(hdr, "si")
                        && !PyDict_GetItemString(hdr, "ep"))
                        is_data = 1;
                }
                int rc;
                if (is_data) {
                    rc = eng_gate_and_match(e, peer, hdr, payload, acts);
                } else {
                    PyObject *act = Py_BuildValue("(sOO)", "frame", hdr,
                                                  payload);
                    rc = act ? PyList_Append(acts, act) : -1;
                    Py_XDECREF(act);
                }
                Py_DECREF(hdr);
                Py_DECREF(payload);
                if (rc < 0) goto fail;
            }
            (void)hdr_staged;
            tail += 8 + total;
            __atomic_store_n((uint64_t *)base + 1, (uint64_t)tail,
                             __ATOMIC_RELEASE);
            nframes++;
        }
    }
    goto batch_done;
fail:
    if (nframes == 0) {
        PyMem_Free(staged);
        Py_DECREF(acts);
        PyBuffer_Release(&mm);
        return NULL;
    }
    /* frames before the bad one are already committed (engine state +
     * shm tail advanced per frame): return their actions — dropping
     * them would hang their completed-in-C recvs.  The next drain call
     * faces the bad frame FIRST, with nothing committed, and raises
     * cleanly for the caller's Unsupported/corrupt recovery. */
    PyErr_Clear();
batch_done:
    PyMem_Free(staged);
    {
        PyObject *out = Py_BuildValue("(LLO)", (long long)tail,
                                      (long long)nframes, acts);
        Py_DECREF(acts);
        PyBuffer_Release(&mm);
        return out;
    }
}

static PyObject *Engine_reset_peer(EngineObject *e, PyObject *args) {
    /* reset_peer(peer): drop the seq gate + held frames toward a peer
     * whose incarnation changed (≈ _adopt_incarnation's recv-side) */
    long long peer;
    if (!PyArg_ParseTuple(args, "L", &peer)) return NULL;
    SeqEntry **sp = &e->seqs;
    while (*sp) {
        if ((*sp)->peer == peer) {
            SeqEntry *dead = *sp;
            *sp = dead->next;
            PyMem_Free(dead);
        } else {
            sp = &(*sp)->next;
        }
    }
    PyObject *keys = PyDict_Keys(e->held);
    if (!keys) return NULL;
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(keys); i++) {
        PyObject *k = PyList_GET_ITEM(keys, i);
        PyObject *kp = PyTuple_GET_ITEM(k, 0);
        if (PyLong_AsLongLong(kp) == peer)
            PyDict_DelItem(e->held, k);
    }
    Py_DECREF(keys);
    Py_RETURN_NONE;
}

static PyObject *Engine_counts(EngineObject *e, PyObject *args) {
    /* counts(cid) → (n_posted, n_unexpected) — introspection/tests */
    long long cid;
    if (!PyArg_ParseTuple(args, "L", &cid)) return NULL;
    int64_t np_ = 0, nu = 0;
    CidEntry *c = eng_cid(e, cid, 0);
    if (c) {
        for (MatchPosted *p = c->ph; p; p = p->next) np_++;
        for (MatchUnex *u = c->uh; u; u = u->next) nu++;
    }
    return Py_BuildValue("(LL)", (long long)np_, (long long)nu);
}

static void Engine_dealloc(EngineObject *e) {
    CidEntry *c = e->cids;
    while (c) {
        MatchPosted *p = c->ph;
        while (p) { MatchPosted *n = p->next; eng_free_posted(p); p = n; }
        MatchUnex *u = c->uh;
        while (u) { MatchUnex *n = u->next; eng_free_unex(u); u = n; }
        CidEntry *cn = c->next;
        PyMem_Free(c);
        c = cn;
    }
    SeqEntry *s = e->seqs;
    while (s) { SeqEntry *n = s->next; PyMem_Free(s); s = n; }
    Py_XDECREF(e->held);
    Py_TYPE(e)->tp_free((PyObject *)e);
}

static PyObject *Engine_new(PyTypeObject *type, PyObject *args,
                            PyObject *kwds) {
    EngineObject *e = (EngineObject *)type->tp_alloc(type, 0);
    if (!e) return NULL;
    e->cids = NULL;
    e->seqs = NULL;
    e->held = PyDict_New();
    if (!e->held) { Py_DECREF(e); return NULL; }
    return (PyObject *)e;
}

static PyMethodDef Engine_methods[] = {
    {"post", (PyCFunction)Engine_post, METH_VARARGS,
     "post(cid, source, tag, req, buf_or_None, itemsize) -> None | "
     "(peer, hdr, payload)"},
    {"cancel", (PyCFunction)Engine_cancel, METH_VARARGS,
     "cancel(cid, req) -> bool"},
    {"iprobe", (PyCFunction)Engine_iprobe, METH_VARARGS,
     "iprobe(cid, source, tag) -> None | (peer, hdr)"},
    {"improbe", (PyCFunction)Engine_improbe, METH_VARARGS,
     "improbe(cid, source, tag) -> None | (peer, hdr, payload)"},
    {"incoming", (PyCFunction)Engine_incoming, METH_VARARGS,
     "incoming(peer, hdr, payload) -> [actions]"},
    {"incoming_fast", (PyCFunction)Engine_incoming_fast, METH_VARARGS,
     "incoming_fast(peer, tag, cid, seq, payload, dt, elems, shp) -> "
     "None | [actions]"},
    {"drain_ring", (PyCFunction)Engine_drain_ring, METH_VARARGS,
     "drain_ring(peer, mm, tail, limit) -> (new_tail, nframes, actions)"},
    {"reset_peer", (PyCFunction)Engine_reset_peer, METH_VARARGS,
     "reset_peer(peer)"},
    {"counts", (PyCFunction)Engine_counts, METH_VARARGS,
     "counts(cid) -> (n_posted, n_unexpected)"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject EngineType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    /* field order matters: this file is compiled as C++ (g++), which
     * enforces declaration-order designated initializers */
    .tp_name = "_fastdss_torch.Engine",
    .tp_basicsize = sizeof(EngineObject),
    .tp_dealloc = (destructor)Engine_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "compiled PML matching engine (call under the PML lock)",
    .tp_methods = Engine_methods,
    .tp_new = Engine_new,
};

/* -- module ------------------------------------------------------------ */

static PyObject *fastdss_ring_send(PyObject *self, PyObject *args);
static PyObject *fastdss_ring_send_fast(PyObject *self, PyObject *args);
static PyObject *fastdss_ring_recv(PyObject *self, PyObject *args);

static PyMethodDef methods[] = {
    {"pack", fastdss_pack, METH_O,
     "pack(tuple_of_values) -> bytes (DSS wire format)"},
    {"unpack", fastdss_unpack, METH_VARARGS,
     "unpack(data[, n]) -> list of values"},
    {"ring_send", fastdss_ring_send, METH_VARARGS,
     "ring_send(mm, head, header, payload) -> (new_head, sleep_flag)"},
    {"ring_send_fast", fastdss_ring_send_fast, METH_VARARGS,
     "ring_send_fast(mm, head, tag, cid, seq, dt, elems, shp, payload)"
     " -> (new_head, sleep_flag)"},
    {"ring_recv", fastdss_ring_recv, METH_VARARGS,
     "ring_recv(mm, tail) -> None | (header, payload, new_tail)"},
    {"atomic_add", fastdss_atomic_add, METH_VARARGS,
     "atomic_add(mm, offset, delta) -> old (u64 fetch-add, acq_rel)"},
    {"atomic_load", fastdss_atomic_load, METH_VARARGS,
     "atomic_load(mm, offset) -> value (u64, acquire)"},
    {"atomic_store", fastdss_atomic_store, METH_VARARGS,
     "atomic_store(mm, offset, value) (u64, release)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastdss_torch",
    "compiled DSS codec for the common control-message subset", -1,
    methods,
};

PyMODINIT_FUNC PyInit__fastdss_torch(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    Unsupported = PyErr_NewException("_fastdss_torch.Unsupported", NULL, NULL);
    if (!Unsupported || PyModule_AddObject(m, "Unsupported", Unsupported) < 0) {
        Py_XDECREF(Unsupported);
        Py_DECREF(m);
        return NULL;
    }
    RingFull = PyErr_NewException("_fastdss_torch.RingFull", NULL, NULL);
    if (!RingFull || PyModule_AddObject(m, "RingFull", RingFull) < 0) {
        Py_XDECREF(RingFull);
        Py_DECREF(m);
        return NULL;
    }
    TooBig = PyErr_NewException("_fastdss_torch.FrameTooBig", NULL, NULL);
    if (!TooBig || PyModule_AddObject(m, "FrameTooBig", TooBig) < 0) {
        Py_XDECREF(TooBig);
        Py_DECREF(m);
        return NULL;
    }
    if (PyType_Ready(&EngineType) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&EngineType);
    if (PyModule_AddObject(m, "Engine", (PyObject *)&EngineType) < 0) {
        Py_DECREF(&EngineType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}

/* -- fused ring framing -------------------------------------------------
 * Encode a header dict + payload DIRECTLY into the shm ring mapping and
 * publish, or decode a frame straight out of it — one C call per frame,
 * no intermediate bytes object (the shm BTL's vader-class data plane).
 * Ring layout matches btl_shm.py / convertor.cpp: u64 head @0 (writer,
 * release-store publishes), u64 tail @8 (reader), u64 capacity @16,
 * u32 magic @24, u64 sleep flag @32, data @64 modulo capacity.
 */

#define RING_HDR 64

static void ring_out(uint8_t *mm, Py_ssize_t cap, Py_ssize_t pos,
                     const uint8_t *src, Py_ssize_t len) {
    Py_ssize_t off = pos % cap;
    Py_ssize_t first = cap - off < len ? cap - off : len;
    memcpy(mm + RING_HDR + off, src, (size_t)first);
    if (first < len)
        memcpy(mm + RING_HDR, src + first, (size_t)(len - first));
}

static void ring_in(const uint8_t *mm, Py_ssize_t cap, Py_ssize_t pos,
                    uint8_t *dst, Py_ssize_t len) {
    Py_ssize_t off = pos % cap;
    Py_ssize_t first = cap - off < len ? cap - off : len;
    memcpy(dst, mm + RING_HDR + off, (size_t)first);
    if (first < len)
        memcpy(dst + first, mm + RING_HDR, (size_t)(len - first));
}


/* shared publish protocol (both senders MUST stay wire-identical):
 * validate the mapping, enforce the single-frame limit, check space,
 * write [lens | header | payload], release-store the new head.
 * Returns new_head ≥ 0 and sets *ring_db (doorbell armed); -1 with a
 * ValueError / FrameTooBig / RingFull set. */
static int64_t ring_publish(Py_buffer *mm, Py_ssize_t head,
                            const uint8_t *hdr, Py_ssize_t hdr_len,
                            Py_buffer *pay, int *ring_db) {
    uint8_t *base = (uint8_t *)mm->buf;
    if (mm->len < RING_HDR) {
        PyErr_SetString(PyExc_ValueError, "ring mapping too small");
        return -1;
    }
    Py_ssize_t cap = (Py_ssize_t)((uint64_t *)base)[2];
    if (cap <= 0 || RING_HDR + cap > mm->len) {
        PyErr_SetString(PyExc_ValueError, "bad ring capacity");
        return -1;
    }
    Py_ssize_t need = 8 + hdr_len + pay->len;
    if (need > cap / 2) {
        PyErr_Format(TooBig,
                     "frame of %zd bytes exceeds the %zd-byte ring's "
                     "single-frame limit", need, cap);
        return -1;
    }
    uint64_t tail = __atomic_load_n((uint64_t *)base + 1,
                                    __ATOMIC_ACQUIRE);
    if ((uint64_t)head - tail + (uint64_t)need > (uint64_t)cap) {
        PyErr_SetString(RingFull, "ring full");
        return -1;
    }
    uint32_t lens[2] = {(uint32_t)(hdr_len + pay->len),
                        (uint32_t)hdr_len};
    ring_out(base, cap, head, (const uint8_t *)lens, 8);
    ring_out(base, cap, head + 8, hdr, hdr_len);
    if (pay->len)
        ring_out(base, cap, head + 8 + hdr_len,
                 (const uint8_t *)pay->buf, pay->len);
    uint64_t new_head = (uint64_t)head + (uint64_t)need;
    __atomic_store_n((uint64_t *)base, new_head, __ATOMIC_RELEASE);
    *ring_db = ((uint64_t *)base)[4] ? 1 : 0;
    return (int64_t)new_head;
}

/* ring_send(mm, head, header, payload) -> (new_head, sleep_flag)
 * Raises RingFull when the frame does not fit right now (caller sleeps
 * and retries), ValueError when it can never fit (> capacity/2), and
 * Unsupported when the header needs the python codec. */
static PyObject *fastdss_ring_send(PyObject *self, PyObject *args) {
    Py_buffer mm, pay;
    Py_ssize_t head;
    PyObject *header;
    if (!PyArg_ParseTuple(args, "w*nOy*", &mm, &head, &header, &pay))
        return NULL;
    Out o = {NULL, 0, 0};
    PyObject *res = NULL;
    if (pack_obj_rec(&o, header) < 0)
        goto done;
    {
        int ring_db = 0;
        int64_t new_head = ring_publish(&mm, head, o.buf, o.len, &pay,
                                        &ring_db);
        if (new_head >= 0)
            res = Py_BuildValue("(Ln)", (long long)new_head,
                                (Py_ssize_t)ring_db);
    }
done:
    PyMem_Free(o.buf);
    PyBuffer_Release(&mm);
    PyBuffer_Release(&pay);
    return res;
}

/* ring_send_fast(mm, head, tag, cid, seq, dt, elems, shp, payload)
 *   -> (new_head, sleep_flag)
 * Builds the plain-eager header {t:"eager",tag,cid,seq,dt,elems,shp}
 * DSS-encoded straight into the ring — the sender-side twin of the
 * engine's fast header scan.  Wire-identical to dss.pack of the same
 * dict; RingFull/FrameTooBig as ring_send. */
static int out_key_str(Out *o, const char *k) {
    size_t n = strlen(k);
    if (out_u8(o, T_STRING) < 0 || out_u32(o, (uint32_t)n) < 0) return -1;
    return out_put(o, k, (Py_ssize_t)n);
}

static int out_i64_field(Out *o, const char *k, int64_t v) {
    if (out_key_str(o, k) < 0 || out_u8(o, T_INT64) < 0) return -1;
    return out_put(o, &v, 8);
}

static PyObject *fastdss_ring_send_fast(PyObject *self, PyObject *args) {
    Py_buffer mm, pay;
    Py_ssize_t head;
    long long tag, cid, seq, elems;
    PyObject *dt, *shp;
    if (!PyArg_ParseTuple(args, "w*nLLLOLO!y*", &mm, &head, &tag, &cid,
                          &seq, &dt, &elems, &PyTuple_Type, &shp, &pay))
        return NULL;
    Out o = {NULL, 0, 0};
    PyObject *res = NULL;
    {
        Py_ssize_t ndim = PyTuple_GET_SIZE(shp);
        Py_ssize_t dlen;
        const char *dstr = PyUnicode_AsUTF8AndSize(dt, &dlen);
        if (!dstr) goto done;
        if (out_u8(&o, T_DICT) < 0 || out_u32(&o, 7) < 0) goto done;
        if (out_key_str(&o, "t") < 0 || out_u8(&o, T_STRING) < 0 ||
            out_u32(&o, 5) < 0 || out_put(&o, "eager", 5) < 0)
            goto done;
        if (out_i64_field(&o, "tag", tag) < 0 ||
            out_i64_field(&o, "cid", cid) < 0 ||
            out_i64_field(&o, "seq", seq) < 0)
            goto done;
        if (out_key_str(&o, "dt") < 0 || out_u8(&o, T_STRING) < 0 ||
            out_u32(&o, (uint32_t)dlen) < 0 || out_put(&o, dstr, dlen) < 0)
            goto done;
        if (out_i64_field(&o, "elems", elems) < 0) goto done;
        if (out_key_str(&o, "shp") < 0 || out_u8(&o, T_LIST) < 0 ||
            out_u32(&o, (uint32_t)ndim) < 0)
            goto done;
        for (Py_ssize_t i = 0; i < ndim; i++) {
            int64_t d = (int64_t)PyLong_AsLongLong(
                PyTuple_GET_ITEM(shp, i));
            if (d == -1 && PyErr_Occurred()) goto done;
            if (out_u8(&o, T_INT64) < 0 || out_put(&o, &d, 8) < 0)
                goto done;
        }
        int ring_db = 0;
        int64_t new_head = ring_publish(&mm, head, o.buf, o.len, &pay,
                                        &ring_db);
        if (new_head >= 0)
            res = Py_BuildValue("(Ln)", (long long)new_head,
                                (Py_ssize_t)ring_db);
    }
done:
    PyMem_Free(o.buf);
    PyBuffer_Release(&mm);
    PyBuffer_Release(&pay);
    return res;
}

/* ring_recv(mm, tail) -> None | (header, payload_bytes, new_tail)
 * Decodes the header straight from the ring (wraparound staged through
 * a stack/heap buffer only when the frame wraps); release-stores the
 * new tail.  Raises ValueError on corruption, Unsupported when the
 * header carries a tag only the python codec knows (caller drains via
 * the python path). */
static PyObject *fastdss_ring_recv(PyObject *self, PyObject *args) {
    Py_buffer mm;
    Py_ssize_t tail;
    if (!PyArg_ParseTuple(args, "w*n", &mm, &tail))
        return NULL;
    PyObject *res = NULL;
    uint8_t *staged = NULL;
    if (mm.len < RING_HDR) {
        PyErr_SetString(PyExc_ValueError, "ring mapping too small");
        goto out;
    }
    {
        uint8_t *base = (uint8_t *)mm.buf;
        Py_ssize_t cap = (Py_ssize_t)((uint64_t *)base)[2];
        if (cap <= 0 || RING_HDR + cap > mm.len) {
            PyErr_SetString(PyExc_ValueError, "bad ring capacity");
            goto out;
        }
        uint64_t head = __atomic_load_n((uint64_t *)base, __ATOMIC_ACQUIRE);
        int64_t avail = (int64_t)(head - (uint64_t)tail);
        if (avail == 0) {
            res = Py_None;
            Py_INCREF(res);
            goto out;
        }
        if (avail < 8 || avail > cap) {
            PyErr_SetString(PyExc_ValueError, "corrupt ring state");
            goto out;
        }
        uint32_t lens[2];
        ring_in(base, cap, tail, (uint8_t *)lens, 8);
        Py_ssize_t total = (Py_ssize_t)lens[0];
        Py_ssize_t hdr_len = (Py_ssize_t)lens[1];
        if (total < hdr_len || 8 + total > avail) {
            PyErr_SetString(PyExc_ValueError, "corrupt ring frame");
            goto out;
        }
        /* frame body: contiguous in the mapping unless it wraps */
        Py_ssize_t body_off = (tail + 8) % cap;
        const uint8_t *body;
        if (body_off + total <= cap) {
            body = base + RING_HDR + body_off;
        } else {
            staged = (uint8_t *)PyMem_Malloc((size_t)total);
            if (!staged) { PyErr_NoMemory(); goto out; }
            ring_in(base, cap, tail + 8, staged, total);
            body = staged;
        }
        In in = {body, hdr_len, 0};
        PyObject *header = unpack_obj_rec(&in);
        if (!header)
            goto out;
        if (in.pos != hdr_len) {
            Py_DECREF(header);
            PyErr_SetString(PyExc_ValueError, "trailing header bytes");
            goto out;
        }
        PyObject *payload = PyBytes_FromStringAndSize(
            (const char *)(body + hdr_len), total - hdr_len);
        if (!payload) { Py_DECREF(header); goto out; }
        /* build the python result BEFORE the tail store publishes the
         * slot back to the writer: an allocation failure here must not
         * desync the shm tail from the reader's python-side mirror */
        uint64_t new_tail = (uint64_t)tail + 8 + (uint64_t)total;
        PyObject *tup = PyTuple_New(3);
        PyObject *nt = PyLong_FromLongLong((long long)new_tail);
        if (!tup || !nt) {
            Py_XDECREF(tup);
            Py_XDECREF(nt);
            Py_DECREF(header);
            Py_DECREF(payload);
            goto out;
        }
        PyTuple_SET_ITEM(tup, 0, header);
        PyTuple_SET_ITEM(tup, 1, payload);
        PyTuple_SET_ITEM(tup, 2, nt);
        __atomic_store_n((uint64_t *)base + 1, new_tail, __ATOMIC_RELEASE);
        res = tup;
    }
out:
    PyMem_Free(staged);
    PyBuffer_Release(&mm);
    return res;
}
