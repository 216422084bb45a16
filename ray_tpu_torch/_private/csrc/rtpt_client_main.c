/* Driver for the C ABI client, given a live actor's direct socket, the
 * session authkey and the actor id.
 *
 *   rtpt_client_test <unix_path> <authkey_hex> <aid_hex>
 *     performs a scripted sequence of calls and prints parseable
 *     results (tests/test_torch_capi.py);
 *   rtpt_client_test <unix_path> <authkey_hex> <aid_hex> call <method>
 *                    <arg_file> <out_file> <repeats>
 *     calls <method> <repeats> times with the bytes of <arg_file> as its
 *     one argument, prints "call_ms <ms>" for each call, writes the last
 *     call's bytes result to <out_file> and prints "ok".
 */
#define _POSIX_C_SOURCE 200809L
#include "rtpt_client.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

static int unhex(const char *s, uint8_t *out, size_t outlen) {
    size_t n = strlen(s);
    size_t i;
    if (n != outlen * 2) return -1;
    for (i = 0; i < outlen; i++) {
        unsigned v;
        if (sscanf(s + 2 * i, "%2x", &v) != 1) return -1;
        out[i] = (uint8_t)v;
    }
    return 0;
}

static void print_value(const char *tag, const rtpt_value *v) {
    switch (v->kind) {
    case RTPT_VAL_NONE:
        printf("%s none\n", tag);
        break;
    case RTPT_VAL_BOOL:
        printf("%s bool %lld\n", tag, (long long)v->i);
        break;
    case RTPT_VAL_INT:
        printf("%s int %lld\n", tag, (long long)v->i);
        break;
    case RTPT_VAL_FLOAT:
        printf("%s float %.9g\n", tag, v->f);
        break;
    case RTPT_VAL_STR:
        printf("%s str %.*s\n", tag, (int)v->len, (const char *)v->data);
        break;
    case RTPT_VAL_BYTES:
        printf("%s bytes %zu\n", tag, v->len);
        break;
    default:
        printf("%s opaque %zu\n", tag, v->len);
    }
}

static double now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static uint8_t *read_file(const char *path, size_t *len) {
    FILE *f = fopen(path, "rb");
    uint8_t *buf = NULL;
    long n;
    if (!f) return NULL;
    if (fseek(f, 0, SEEK_END) == 0 && (n = ftell(f)) >= 0 &&
        fseek(f, 0, SEEK_SET) == 0 && (buf = malloc(n ? (size_t)n : 1)) &&
        fread(buf, 1, (size_t)n, f) == (size_t)n) {
        *len = (size_t)n;
    } else {
        free(buf);
        buf = NULL;
    }
    fclose(f);
    return buf;
}

/* The "call" mode: <method> <arg_file> <out_file> <repeats>. */
static int call_mode(rtpt_conn *c, const uint8_t aid[16], char **argv) {
    char err[256];
    rtpt_value result;
    size_t len = 0;
    int repeats = atoi(argv[3]);
    uint8_t *arg = read_file(argv[1], &len);
    if (!arg || repeats < 1) {
        fprintf(stderr, "bad call args\n");
        return 2;
    }
    rtpt_value args[1] = {{.kind = RTPT_VAL_BYTES, .data = arg, .len = len}};
    for (int i = 0; i < repeats; i++) {
        double t0 = now_ms();
        int rc = rtpt_actor_call(c, aid, argv[0], args, 1, &result, err, sizeof err);
        double ms = now_ms() - t0;
        if (rc) {
            fprintf(stderr, "%s: rc %d: %s\n", argv[0], rc, err);
            return 1;
        }
        printf("call_ms %.6f\n", ms);
    }
    free(arg);
    if (result.kind != RTPT_VAL_BYTES) {
        fprintf(stderr, "%s: result kind %d, not bytes\n", argv[0], (int)result.kind);
        return 1;
    }
    FILE *out = fopen(argv[2], "wb");
    if (!out || fwrite(result.data, 1, result.len, out) != result.len || fclose(out)) {
        fprintf(stderr, "cannot write %s\n", argv[2]);
        return 1;
    }
    printf("ok\n");
    return 0;
}

int main(int argc, char **argv) {
    char err[256];
    uint8_t authkey[32], aid[16];
    rtpt_value result;

    setvbuf(stdout, NULL, _IOLBF, 0); /* progress visible under a pipe */
    int call = argc == 9 && strcmp(argv[4], "call") == 0;
    if (argc != 4 && !call) {
        fprintf(stderr, "usage: %s <path> <authkey_hex> <aid_hex> "
                        "[call <method> <arg_file> <out_file> <repeats>]\n", argv[0]);
        return 2;
    }
    size_t keylen = strlen(argv[2]) / 2;
    if (keylen > sizeof authkey || unhex(argv[2], authkey, keylen) ||
        unhex(argv[3], aid, 16)) {
        fprintf(stderr, "bad hex args\n");
        return 2;
    }
    rtpt_conn *c = rtpt_connect(argv[1], authkey, keylen, err, sizeof err);
    if (!c) {
        fprintf(stderr, "connect: %s\n", err);
        return 1;
    }
    fprintf(stderr, "connected\n");
    if (call) {
        int rc = call_mode(c, aid, argv + 5);
        rtpt_close(c);
        return rc;
    }

    /* str result, no args */
    if (rtpt_actor_call(c, aid, "ping", NULL, 0, &result, err, sizeof err)) {
        fprintf(stderr, "ping: %s\n", err);
        return 1;
    }
    print_value("ping", &result);

    /* int result, int args */
    rtpt_value add_args[2] = {
        {.kind = RTPT_VAL_INT, .i = 40},
        {.kind = RTPT_VAL_INT, .i = 2},
    };
    if (rtpt_actor_call(c, aid, "add", add_args, 2, &result, err, sizeof err)) {
        fprintf(stderr, "add: %s\n", err);
        return 1;
    }
    print_value("add", &result);

    /* big int through LONG1 both ways */
    rtpt_value big_args[1] = {
        {.kind = RTPT_VAL_INT, .i = 1234567890123456789LL},
    };
    if (rtpt_actor_call(c, aid, "add1", big_args, 1, &result, err, sizeof err)) {
        fprintf(stderr, "add1: %s\n", err);
        return 1;
    }
    print_value("add1", &result);

    /* float round trip */
    rtpt_value f_args[1] = {{.kind = RTPT_VAL_FLOAT, .f = 1.5}};
    if (rtpt_actor_call(c, aid, "fmul", f_args, 1, &result, err, sizeof err)) {
        fprintf(stderr, "fmul: %s\n", err);
        return 1;
    }
    print_value("fmul", &result);

    /* bytes echo */
    static const uint8_t blob[300] = {7};
    rtpt_value b_args[1] = {
        {.kind = RTPT_VAL_BYTES, .data = blob, .len = sizeof blob},
    };
    if (rtpt_actor_call(c, aid, "echo_len", b_args, 1, &result, err,
                        sizeof err)) {
        fprintf(stderr, "echo_len: %s\n", err);
        return 1;
    }
    print_value("echo_len", &result);

    /* str args */
    rtpt_value s_args[1] = {
        {.kind = RTPT_VAL_STR, .data = (const uint8_t *)"wörld", .len = 6},
    };
    if (rtpt_actor_call(c, aid, "greet", s_args, 1, &result, err, sizeof err)) {
        fprintf(stderr, "greet: %s\n", err);
        return 1;
    }
    print_value("greet", &result);

    /* remote exception surfaces as RTPT_ERR_REMOTE */
    int rc = rtpt_actor_call(c, aid, "boom", NULL, 0, &result, err, sizeof err);
    printf("boom rc %d\n", rc);

    /* connection survives the error */
    if (rtpt_actor_call(c, aid, "ping", NULL, 0, &result, err, sizeof err)) {
        fprintf(stderr, "ping2: %s\n", err);
        return 1;
    }
    print_value("ping2", &result);

    rtpt_close(c);
    printf("ok\n");
    return 0;
}
