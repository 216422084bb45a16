/* C ABI client for the ray_tpu_torch direct call plane. See rtpt_client.h.
 *
 * Wire stack, bottom to top (all reimplemented here, no deps):
 *   unix stream socket
 *   multiprocessing.connection framing: u32 big-endian length prefix
 *   1-RTT HMAC-SHA256 token handshake (transport.py unix scheme)
 *   fastpath.c typed frames (0xF1 magic, K_CALL/K_REPLY)
 *   serialization.py value layout ("RTPUOBJ1" header + pickle)
 *   a pickle protocol-3 writer / protocol-5 reader for simple values
 */
#include "rtpt_client.h"

#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <sys/random.h>
#include <unistd.h>

/* ============================== SHA-256 ============================== */

typedef struct {
    uint32_t h[8];
    uint64_t nbytes;
    uint8_t block[64];
    size_t fill;
} sha256_ctx;

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_init(sha256_ctx *c) {
    static const uint32_t iv[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
    };
    memcpy(c->h, iv, sizeof iv);
    c->nbytes = 0;
    c->fill = 0;
}

static void sha256_block(sha256_ctx *c, const uint8_t *p) {
    uint32_t w[64], a, b, d, e, f, g, hh, t1, t2, cc;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
               (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
    for (; i < 64; i++) {
        uint32_t s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    a = c->h[0]; b = c->h[1]; cc = c->h[2]; d = c->h[3];
    e = c->h[4]; f = c->h[5]; g = c->h[6]; hh = c->h[7];
    for (i = 0; i < 64; i++) {
        uint32_t S1 = ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        t1 = hh + S1 + ch + K256[i] + w[i];
        uint32_t S0 = ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22);
        uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += hh;
}

static void sha256_update(sha256_ctx *c, const void *data, size_t n) {
    const uint8_t *p = data;
    c->nbytes += n;
    if (c->fill) {
        while (n && c->fill < 64) { c->block[c->fill++] = *p++; n--; }
        if (c->fill == 64) { sha256_block(c, c->block); c->fill = 0; }
    }
    while (n >= 64) { sha256_block(c, p); p += 64; n -= 64; }
    while (n) { c->block[c->fill++] = *p++; n--; }
}

static void sha256_final(sha256_ctx *c, uint8_t out[32]) {
    uint64_t bits = c->nbytes * 8;
    uint8_t pad = 0x80, zero = 0, lenb[8];
    int i;
    sha256_update(c, &pad, 1);
    while (c->fill != 56) sha256_update(c, &zero, 1);
    for (i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
    sha256_update(c, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(c->h[i] >> 24);
        out[4 * i + 1] = (uint8_t)(c->h[i] >> 16);
        out[4 * i + 2] = (uint8_t)(c->h[i] >> 8);
        out[4 * i + 3] = (uint8_t)c->h[i];
    }
}

static void hmac_sha256(const uint8_t *key, size_t keylen,
                        const uint8_t *msg, size_t msglen, uint8_t out[32]) {
    uint8_t kblock[64], pad[64], khash[32];
    sha256_ctx c;
    size_t i;
    if (keylen > 64) {
        sha256_init(&c);
        sha256_update(&c, key, keylen);
        sha256_final(&c, khash);
        key = khash;
        keylen = 32;
    }
    memset(kblock, 0, 64);
    memcpy(kblock, key, keylen);
    for (i = 0; i < 64; i++) pad[i] = kblock[i] ^ 0x36;
    sha256_init(&c);
    sha256_update(&c, pad, 64);
    sha256_update(&c, msg, msglen);
    sha256_final(&c, out);
    for (i = 0; i < 64; i++) pad[i] = kblock[i] ^ 0x5c;
    sha256_init(&c);
    sha256_update(&c, pad, 64);
    sha256_update(&c, out, 32);
    sha256_final(&c, out);
}

/* ======================= socket + mp framing ======================== */

struct rtpt_conn {
    int fd;
    uint32_t req_id;
    uint8_t *reply;      /* last raw reply frame (owns result memory) */
    size_t reply_len;
    char strerr[256];
};

static int set_err(char *err, size_t errlen, const char *msg) {
    if (err && errlen) {
        strncpy(err, msg, errlen - 1);
        err[errlen - 1] = 0;
    }
    return -1;
}

static int read_full(int fd, void *buf, size_t n) {
    uint8_t *p = buf;
    while (n) {
        ssize_t r = read(fd, p, n);
        if (r <= 0) {
            if (r < 0 && errno == EINTR) continue;
            return -1;
        }
        p += r;
        n -= (size_t)r;
    }
    return 0;
}

static int write_full(int fd, const void *buf, size_t n) {
    const uint8_t *p = buf;
    while (n) {
        ssize_t r = write(fd, p, n);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        p += r;
        n -= (size_t)r;
    }
    return 0;
}

/* multiprocessing.connection: u32 BIG-endian length, then payload. */
static int mp_send(int fd, const uint8_t *payload, size_t n) {
    uint8_t hdr[4] = {
        (uint8_t)(n >> 24), (uint8_t)(n >> 16), (uint8_t)(n >> 8), (uint8_t)n,
    };
    if (write_full(fd, hdr, 4)) return -1;
    return write_full(fd, payload, n);
}

static int mp_recv(int fd, uint8_t **out, size_t *outlen) {
    uint8_t hdr[4];
    if (read_full(fd, hdr, 4)) return -1;
    uint32_t n = (uint32_t)hdr[0] << 24 | (uint32_t)hdr[1] << 16 |
                 (uint32_t)hdr[2] << 8 | hdr[3];
    if (n == 0xFFFFFFFF) return -1; /* >2GB extension: not for replies */
    uint8_t *buf = malloc(n ? n : 1);
    if (!buf) return -1;
    if (read_full(fd, buf, n)) { free(buf); return -1; }
    *out = buf;
    *outlen = n;
    return 0;
}

/* ========================= pickle writer ============================ */
/* Protocol 3: BINUNICODE/SHORT_BINBYTES are available and the server's
 * pickle.loads accepts any protocol <= its own. */

typedef struct {
    uint8_t *p;
    size_t len, cap;
} wbuf;

static int wb_put(wbuf *b, const void *data, size_t n) {
    if (b->len + n > b->cap) {
        size_t cap = b->cap * 2 + n + 64;
        uint8_t *q = realloc(b->p, cap);
        if (!q) return -1;
        b->p = q;
        b->cap = cap;
    }
    memcpy(b->p + b->len, data, n);
    b->len += n;
    return 0;
}

static int wb_u8(wbuf *b, uint8_t v) { return wb_put(b, &v, 1); }

static int wb_u32le(wbuf *b, uint32_t v) {
    uint8_t x[4] = {(uint8_t)v, (uint8_t)(v >> 8), (uint8_t)(v >> 16),
                    (uint8_t)(v >> 24)};
    return wb_put(b, x, 4);
}

static int pkl_value(wbuf *b, const rtpt_value *v) {
    switch (v->kind) {
    case RTPT_VAL_NONE:
        return wb_u8(b, 'N');
    case RTPT_VAL_BOOL:
        return wb_u8(b, v->i ? 0x88 : 0x89); /* NEWTRUE/NEWFALSE */
    case RTPT_VAL_INT:
        if (v->i >= -2147483648LL && v->i <= 2147483647LL) {
            if (wb_u8(b, 'J')) return -1; /* BININT i32 LE */
            return wb_u32le(b, (uint32_t)(int32_t)v->i);
        } else {
            /* LONG1: u8 nbytes + LE two's-complement */
            uint8_t tmp[9];
            int n = 0;
            int64_t x = v->i;
            do {
                tmp[n++] = (uint8_t)x;
                x >>= 8;
            } while (n < 8 && x != 0 && x != -1);
            /* sign byte if top bit disagrees with sign */
            if ((v->i >= 0 && (tmp[n - 1] & 0x80)) ||
                (v->i < 0 && !(tmp[n - 1] & 0x80)))
                tmp[n++] = v->i < 0 ? 0xFF : 0x00;
            if (wb_u8(b, 0x8a) || wb_u8(b, (uint8_t)n)) return -1;
            return wb_put(b, tmp, (size_t)n);
        }
    case RTPT_VAL_FLOAT: {
        uint64_t bits;
        uint8_t be[8];
        int i;
        memcpy(&bits, &v->f, 8);
        for (i = 0; i < 8; i++) be[i] = (uint8_t)(bits >> (56 - 8 * i));
        if (wb_u8(b, 'G')) return -1; /* BINFLOAT, big-endian */
        return wb_put(b, be, 8);
    }
    case RTPT_VAL_STR:
        if (wb_u8(b, 'X') || wb_u32le(b, (uint32_t)v->len)) return -1;
        return wb_put(b, v->data, v->len);
    case RTPT_VAL_BYTES:
        if (v->len < 256) {
            if (wb_u8(b, 'C') || wb_u8(b, (uint8_t)v->len)) return -1;
        } else {
            if (wb_u8(b, 'B') || wb_u32le(b, (uint32_t)v->len)) return -1;
        }
        return wb_put(b, v->data, v->len);
    default:
        return -1; /* OPAQUE not valid as an argument */
    }
}

/* pickle of ((args...), {}) — what serialization.unpack returns as
 * (args, kwargs). */
static int pkl_args(wbuf *b, const rtpt_value *args, size_t nargs) {
    size_t i;
    if (wb_u8(b, 0x80) || wb_u8(b, 3)) return -1; /* PROTO 3 */
    if (nargs == 0) {
        if (wb_u8(b, ')')) return -1; /* EMPTY_TUPLE */
    } else if (nargs <= 3) {
        for (i = 0; i < nargs; i++)
            if (pkl_value(b, &args[i])) return -1;
        if (wb_u8(b, (uint8_t)(0x85 + nargs - 1))) return -1; /* TUPLE1-3 */
    } else {
        if (wb_u8(b, '(')) return -1; /* MARK */
        for (i = 0; i < nargs; i++)
            if (pkl_value(b, &args[i])) return -1;
        if (wb_u8(b, 't')) return -1; /* TUPLE */
    }
    if (wb_u8(b, '}')) return -1;    /* EMPTY_DICT (kwargs) */
    if (wb_u8(b, 0x86)) return -1;   /* TUPLE2 */
    return wb_u8(b, '.');            /* STOP */
}

/* ========================= pickle reader ============================ */
/* Protocol-5 subset for simple scalar results; anything richer falls
 * back to RTPT_VAL_OPAQUE with the raw serialized blob. */

static int pkl_read_value(const uint8_t *p, size_t n, rtpt_value *out) {
    size_t off = 0;
    int have = 0;
    memset(out, 0, sizeof *out);
    while (off < n) {
        uint8_t op = p[off++];
        switch (op) {
        case 0x80: /* PROTO */
            if (off + 1 > n) return -1;
            off += 1;
            break;
        case 0x95: /* FRAME (proto 4+) */
            if (off + 8 > n) return -1;
            off += 8;
            break;
        case 0x94: /* MEMOIZE */
            break;
        case 'N':
            out->kind = RTPT_VAL_NONE;
            have = 1;
            break;
        case 0x88:
        case 0x89:
            out->kind = RTPT_VAL_BOOL;
            out->i = (op == 0x88);
            have = 1;
            break;
        case 'K': /* BININT1 */
            if (off + 1 > n) return -1;
            out->kind = RTPT_VAL_INT;
            out->i = p[off];
            off += 1;
            have = 1;
            break;
        case 'M': /* BININT2 */
            if (off + 2 > n) return -1;
            out->kind = RTPT_VAL_INT;
            out->i = (int64_t)p[off] | ((int64_t)p[off + 1] << 8);
            off += 2;
            have = 1;
            break;
        case 'J': /* BININT i32 LE */
            if (off + 4 > n) return -1;
            out->kind = RTPT_VAL_INT;
            out->i = (int32_t)((uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                               ((uint32_t)p[off + 2] << 16) |
                               ((uint32_t)p[off + 3] << 24));
            off += 4;
            have = 1;
            break;
        case 0x8a: { /* LONG1 */
            if (off + 1 > n) return -1;
            uint8_t ln = p[off++];
            if (ln > 8 || off + ln > n) return -1;
            int64_t v = 0;
            int i;
            for (i = 0; i < ln; i++) v |= (int64_t)p[off + i] << (8 * i);
            if (ln && ln < 8 && (p[off + ln - 1] & 0x80))
                v -= (int64_t)1 << (8 * ln); /* sign-extend */
            out->kind = RTPT_VAL_INT;
            out->i = v;
            off += ln;
            have = 1;
            break;
        }
        case 'G': { /* BINFLOAT BE */
            if (off + 8 > n) return -1;
            uint64_t bits = 0;
            int i;
            for (i = 0; i < 8; i++) bits = (bits << 8) | p[off + i];
            memcpy(&out->f, &bits, 8);
            out->kind = RTPT_VAL_FLOAT;
            off += 8;
            have = 1;
            break;
        }
        case 0x8c: { /* SHORT_BINUNICODE */
            if (off + 1 > n) return -1;
            uint8_t ln = p[off++];
            if (off + ln > n) return -1;
            out->kind = RTPT_VAL_STR;
            out->data = p + off;
            out->len = ln;
            off += ln;
            have = 1;
            break;
        }
        case 'X': { /* BINUNICODE u32 LE */
            if (off + 4 > n) return -1;
            uint32_t ln = (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                          ((uint32_t)p[off + 2] << 16) |
                          ((uint32_t)p[off + 3] << 24);
            off += 4;
            if (off + ln > n) return -1;
            out->kind = RTPT_VAL_STR;
            out->data = p + off;
            out->len = ln;
            off += ln;
            have = 1;
            break;
        }
        case 'C': { /* SHORT_BINBYTES */
            if (off + 1 > n) return -1;
            uint8_t ln = p[off++];
            if (off + ln > n) return -1;
            out->kind = RTPT_VAL_BYTES;
            out->data = p + off;
            out->len = ln;
            off += ln;
            have = 1;
            break;
        }
        case 'B': { /* BINBYTES u32 LE */
            if (off + 4 > n) return -1;
            uint32_t ln = (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                          ((uint32_t)p[off + 2] << 16) |
                          ((uint32_t)p[off + 3] << 24);
            off += 4;
            if (off + ln > n) return -1;
            out->kind = RTPT_VAL_BYTES;
            out->data = p + off;
            out->len = ln;
            off += ln;
            have = 1;
            break;
        }
        case '.': /* STOP */
            return have ? 0 : -1;
        default:
            return -1; /* containers, reduce, memo refs: opaque */
        }
    }
    return -1;
}

/* ======================= fastpath frame codec ======================= */

#define MAGIC_BYTE 0xF1
#define K_CALL 1
#define K_REPLY 2

static int frame_bstr(wbuf *b, const uint8_t *data, size_t n) {
    if (wb_u32le(b, (uint32_t)n)) return -1;
    return wb_put(b, data, n);
}

/* ============================== API ================================ */

rtpt_conn *rtpt_connect(const char *unix_path, const uint8_t *authkey,
                        size_t authkey_len, char *err, size_t errlen) {
    static const char CLIENT_TAG[] = "rtpu-conn-auth-v1:client";
    static const char SERVER_TAG[] = "rtpu-conn-auth-v1:server";
    uint8_t tok[32], want[32], *srv = NULL;
    size_t srvlen = 0;
    struct sockaddr_un sa;
    rtpt_conn *c;
    int fd;

    if (strlen(unix_path) >= sizeof sa.sun_path) {
        set_err(err, errlen, "socket path too long");
        return NULL;
    }
    fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) {
        set_err(err, errlen, "socket() failed");
        return NULL;
    }
    memset(&sa, 0, sizeof sa);
    sa.sun_family = AF_UNIX;
    strcpy(sa.sun_path, unix_path);
    if (connect(fd, (struct sockaddr *)&sa, sizeof sa)) {
        close(fd);
        set_err(err, errlen, "connect() failed");
        return NULL;
    }
    /* 1-RTT token handshake (transport.py unix scheme). */
    hmac_sha256(authkey, authkey_len, (const uint8_t *)CLIENT_TAG,
                sizeof CLIENT_TAG - 1, tok);
    if (mp_send(fd, tok, 32) || mp_recv(fd, &srv, &srvlen)) {
        close(fd);
        set_err(err, errlen, "handshake I/O failed");
        return NULL;
    }
    hmac_sha256(authkey, authkey_len, (const uint8_t *)SERVER_TAG,
                sizeof SERVER_TAG - 1, want);
    if (srvlen != 32 || memcmp(srv, want, 32) != 0) {
        free(srv);
        close(fd);
        set_err(err, errlen, "server failed auth");
        return NULL;
    }
    free(srv);
    c = calloc(1, sizeof *c);
    if (!c) {
        close(fd);
        set_err(err, errlen, "oom");
        return NULL;
    }
    c->fd = fd;
    c->req_id = 1;
    return c;
}

void rtpt_close(rtpt_conn *c) {
    if (!c) return;
    close(c->fd);
    free(c->reply);
    free(c);
}

/* Parse one obytes/ostr: returns 0, fills data+len (NULL if absent). */
static int rd_opt(const uint8_t **pp, const uint8_t *end,
                  const uint8_t **data, size_t *len) {
    const uint8_t *p = *pp;
    if (p >= end) return -1;
    if (*p == 0) {
        *data = NULL;
        *len = 0;
        *pp = p + 1;
        return 0;
    }
    p += 1;
    if (p + 4 > end) return -1;
    uint32_t n = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                 ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    p += 4;
    if (p + n > end) return -1;
    *data = p;
    *len = n;
    *pp = p + n;
    return 0;
}

int rtpt_actor_call(rtpt_conn *c, const uint8_t aid[16], const char *method,
                    const rtpt_value *args, size_t nargs, rtpt_value *result,
                    char *err, size_t errlen) {
    wbuf pkl = {0}, frame = {0};
    uint8_t tid[16];
    uint32_t req = c->req_id++;
    size_t mlen = strlen(method);

    if (getentropy(tid, 16)) {
        /* extremely unlikely; derive from req counter */
        memset(tid, 0, 16);
        memcpy(tid, &req, 4);
    }
    /* args blob: serialization layout with zero out-of-band buffers. */
    if (pkl_args(&pkl, args, nargs)) {
        free(pkl.p);
        return set_err(err, errlen, "unsupported argument kind");
    }
    uint8_t hdr[16];
    memcpy(hdr, "RTPUOBJ1", 8);
    uint32_t plen = (uint32_t)pkl.len;
    hdr[8] = (uint8_t)plen; hdr[9] = (uint8_t)(plen >> 8);
    hdr[10] = (uint8_t)(plen >> 16); hdr[11] = (uint8_t)(plen >> 24);
    memset(hdr + 12, 0, 4); /* nbuffers = 0 */

    /* CALL frame (fastpath.c layout). */
    int bad = 0;
    bad |= wb_u8(&frame, MAGIC_BYTE);
    bad |= wb_u8(&frame, K_CALL);
    bad |= wb_u32le(&frame, req);
    bad |= frame_bstr(&frame, tid, 16);           /* bstr tid */
    bad |= wb_u8(&frame, 0);                      /* obytes fid: None */
    bad |= wb_u8(&frame, 1);                      /* ostr method present */
    bad |= wb_u32le(&frame, (uint32_t)mlen);
    bad |= wb_put(&frame, method, mlen);
    bad |= wb_u32le(&frame, (uint32_t)(16 + pkl.len)); /* bstr args */
    bad |= wb_put(&frame, hdr, 16);
    bad |= wb_put(&frame, pkl.p, pkl.len);
    bad |= wb_u32le(&frame, 1);                   /* nret */
    bad |= wb_u8(&frame, 1);                      /* obytes aid present */
    bad |= wb_u32le(&frame, 16);
    bad |= wb_put(&frame, aid, 16);
    bad |= wb_u8(&frame, 0);                      /* ostr cgroup: None */
    free(pkl.p);
    if (bad) {
        free(frame.p);
        return set_err(err, errlen, "oom");
    }
    int rc = mp_send(c->fd, frame.p, frame.len);
    free(frame.p);
    if (rc) return set_err(err, errlen, "send failed"), RTPT_ERR_IO;

    /* Reply: skip frames until our req_id (RDY pushes may interleave). */
    for (;;) {
        uint8_t *buf;
        size_t n;
        if (mp_recv(c->fd, &buf, &n))
            return set_err(err, errlen, "recv failed"), RTPT_ERR_IO;
        if (n < 6 || buf[0] != MAGIC_BYTE || buf[1] != K_REPLY) {
            free(buf); /* not a reply (readiness push etc.): skip */
            continue;
        }
        uint32_t rid = (uint32_t)buf[2] | ((uint32_t)buf[3] << 8) |
                       ((uint32_t)buf[4] << 16) | ((uint32_t)buf[5] << 24);
        if (rid != req) {
            free(buf);
            continue;
        }
        free(c->reply);
        c->reply = buf;
        c->reply_len = n;
        const uint8_t *p = buf + 6, *end = buf + n;
        const uint8_t *eblob, *inline_b, *segment;
        size_t eblen, inlen, seglen;
        if (rd_opt(&p, end, &eblob, &eblen))
            return set_err(err, errlen, "bad reply"), RTPT_ERR_PROTO;
        if (eblob != NULL) {
            /* Remote exception: serialized RayTaskError/RayActorError.
             * Surface the raw blob so a Python helper can rehydrate. */
            if (result) {
                memset(result, 0, sizeof *result);
                result->kind = RTPT_VAL_OPAQUE;
                result->data = eblob;
                result->len = eblen;
            }
            set_err(err, errlen, "remote task error (serialized blob "
                                 "in result)");
            return RTPT_ERR_REMOTE;
        }
        if (p + 2 > end)
            return set_err(err, errlen, "bad reply"), RTPT_ERR_PROTO;
        uint16_t nres = (uint16_t)(p[0] | (p[1] << 8));
        p += 2;
        if (nres < 1)
            return set_err(err, errlen, "empty reply"), RTPT_ERR_PROTO;
        if (rd_opt(&p, end, &inline_b, &inlen))
            return set_err(err, errlen, "bad reply"), RTPT_ERR_PROTO;
        if (rd_opt(&p, end, &segment, &seglen))
            return set_err(err, errlen, "bad reply"), RTPT_ERR_PROTO;
        if (inline_b == NULL) {
            /* Sealed into the shared store: out of scope for the C
             * embed client (results must fit inline). */
            return set_err(err, errlen,
                           "result in shared segment; use the Python "
                           "client for large results"),
                   RTPT_ERR_PROTO;
        }
        /* inline blob = serialization layout; parse header. */
        if (inlen < 16 || memcmp(inline_b, "RTPUOBJ1", 8) != 0)
            return set_err(err, errlen, "bad value header"), RTPT_ERR_PROTO;
        uint32_t vplen = (uint32_t)inline_b[8] | ((uint32_t)inline_b[9] << 8) |
                         ((uint32_t)inline_b[10] << 16) |
                         ((uint32_t)inline_b[11] << 24);
        uint32_t nbuf = (uint32_t)inline_b[12] | ((uint32_t)inline_b[13] << 8) |
                        ((uint32_t)inline_b[14] << 16) |
                        ((uint32_t)inline_b[15] << 24);
        const uint8_t *pp = inline_b + 16 + 8 * (size_t)nbuf;
        if (pp + vplen > inline_b + inlen)
            return set_err(err, errlen, "bad value header"), RTPT_ERR_PROTO;
        if (result) {
            if (nbuf != 0 || pkl_read_value(pp, vplen, result)) {
                /* Rich value (container, ndarray, custom class): give
                 * the caller the raw serialized blob. */
                memset(result, 0, sizeof *result);
                result->kind = RTPT_VAL_OPAQUE;
                result->data = inline_b;
                result->len = inlen;
            }
        }
        return RTPT_OK;
    }
}
