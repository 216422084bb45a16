/* rtpt_client: minimal C ABI client for ray_tpu_torch's direct call plane.
 *
 * Reference parity note: the reference ships a full C++ worker API
 * (cpp/, 9.1k LoC) that can host actors and submit arbitrary tasks.
 * ray_tpu_torch's compute path is PyTorch/Python by design, so the C surface
 * targets the embed case instead: a C/C++ service calling methods on
 * an already-deployed actor over the worker's direct socket — the
 * same typed binary frames the Python fast path uses (fastpath.c
 * CALL/REPLY layout), with no Python dependency.
 *
 * Capabilities:
 *   - connect to a worker direct socket (unix path + session authkey;
 *     the 1-RTT HMAC-SHA256 token handshake from transport.py)
 *   - call an actor method with positional args of simple types
 *     (none/bool/int/double/str/bytes)
 *   - receive inline results of the same simple types; larger or
 *     richer results are surfaced as the raw serialized blob
 *     (RTPT_VAL_OPAQUE) for the caller to hand to a Python helper.
 *
 * Thread-safety: one rtpt_conn per thread (calls are synchronous
 * request/reply on one socket).
 */
#ifndef RTPT_CLIENT_H
#define RTPT_CLIENT_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct rtpt_conn rtpt_conn;

/* Value kinds for args and results. */
typedef enum {
    RTPT_VAL_NONE = 0,
    RTPT_VAL_BOOL = 1,
    RTPT_VAL_INT = 2,     /* int64 */
    RTPT_VAL_FLOAT = 3,   /* double */
    RTPT_VAL_STR = 4,     /* utf-8, data/len */
    RTPT_VAL_BYTES = 5,   /* data/len */
    RTPT_VAL_OPAQUE = 6,  /* raw serialized value (results only) */
} rtpt_val_kind;

typedef struct {
    rtpt_val_kind kind;
    int64_t i;           /* BOOL/INT */
    double f;            /* FLOAT */
    const uint8_t *data; /* STR/BYTES/OPAQUE (result: owned by reply) */
    size_t len;
} rtpt_value;

/* Returns NULL on failure and fills err (NUL-terminated). authkey is
 * the session key (ray_tpu_torch exports it hex; pass raw bytes here). */
rtpt_conn *rtpt_connect(const char *unix_path, const uint8_t *authkey,
                        size_t authkey_len, char *err, size_t errlen);

void rtpt_close(rtpt_conn *c);

/* Synchronous actor method call. aid = 16-byte actor id. args is an
 * array of nargs rtpt_value (STR/BYTES point into caller memory).
 * On success returns 0 and fills *result; STR/BYTES/OPAQUE result data
 * stays valid until the next call on this conn. On application error
 * returns RTPT_ERR_REMOTE and fills err with the remote error text if
 * extractable. */
#define RTPT_OK 0
#define RTPT_ERR_IO (-1)
#define RTPT_ERR_PROTO (-2)
#define RTPT_ERR_REMOTE (-3)

int rtpt_actor_call(rtpt_conn *c, const uint8_t aid[16],
                    const char *method, const rtpt_value *args,
                    size_t nargs, rtpt_value *result, char *err,
                    size_t errlen);

#ifdef __cplusplus
}
#endif
#endif
