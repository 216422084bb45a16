// Multi-process crash/stress harness for the pool store.
//
// Reference behavior being defended: the plasma store survives client
// crashes (the reference runs its object-store tests under ASAN/TSAN —
// .bazelrc:104-126). Here: N writers + N readers hammer one pool while
// a victim writer is SIGKILLed mid-operation (often while holding the
// process-shared robust mutex); every round the parent then proves the
// pool is still consistent and usable — the EOWNERDEAD recovery path,
// the boundary-tag allocator, and the shared refcounts all hold.
//
// Build: ray_tpu_torch._private.native_tools.build("store_stress") or
// build("store_stress_asan"), into ray_tpu_torch/_private/_native/
// Run:   store_stress [rounds=5] [writers=4]
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <sys/wait.h>
#include <unistd.h>
#include <signal.h>

#include "store.cpp"

static void make_id(uint8_t* id, int writer, int counter) {
  memset(id, 0, 16);
  id[0] = (uint8_t)(writer + 1);
  memcpy(id + 1, &counter, sizeof(counter));
}

static int writer_proc(const char* pool, int idx, int ops, bool victim) {
  uint64_t h = store_attach(pool);
  if (!h) return 2;
  uint8_t* base = (uint8_t*)((Store*)h)->base;  // payload writes
  srand(getpid());
  for (int i = 0; i < ops; i++) {
    uint8_t id[16];
    make_id(id, idx, i);
    uint64_t size = 256 + (rand() % 4096);
    int32_t err = 0;
    uint64_t off = store_create_object(h, id, size, &err);
    if (off) {
      memset(base + off, (uint8_t)(idx + 1), size);
      store_seal(h, id);
    }
    if (i >= 8 && (rand() % 4) == 0) {
      uint8_t old_id[16];
      make_id(old_id, idx, i - 8);
      store_delete(h, old_id);
    }
    if (victim && i == ops / 2) {
      // Die without warning, plausibly inside the critical section of
      // a concurrent create on another iteration's timing.
      kill(getpid(), SIGKILL);
    }
  }
  store_detach(h);
  return 0;
}

static int reader_proc(const char* pool, int writers, int ops) {
  uint64_t h = store_attach(pool);
  if (!h) return 2;
  uint8_t* base = (uint8_t*)((Store*)h)->base;
  srand(getpid() * 7);
  for (int i = 0; i < ops; i++) {
    uint8_t id[16];
    int w = rand() % writers;
    make_id(id, w, rand() % 64);
    uint64_t off = 0, size = 0;
    if (store_get(h, id, &off, &size) == 0) {
      // Sealed data must carry the writer's fill byte throughout.
      uint8_t want = (uint8_t)(w + 1);
      for (uint64_t j = 0; j < size; j += 97) {
        if (base[off + j] != want) {
          fprintf(stderr, "CORRUPTION: id w%d obj, byte %lu = %u != %u\n",
                  w, (unsigned long)j, base[off + j], want);
          return 3;
        }
      }
      store_release(h, id);
    }
  }
  store_detach(h);
  return 0;
}

int main(int argc, char** argv) {
  int rounds = argc > 1 ? atoi(argv[1]) : 5;
  int writers = argc > 2 ? atoi(argv[2]) : 4;
  if (writers < 1) writers = 1;
  if (writers > 24) writers = 24;  // pids[] holds 2*writers entries
  char pool[64];
  snprintf(pool, sizeof(pool), "/rtpt_stress_%d", (int)getpid());

  for (int round = 0; round < rounds; round++) {
    uint64_t h = store_create(pool, 16ull << 20, 4096, 0);
    if (!h) { fprintf(stderr, "create failed\n"); return 1; }

    pid_t pids[64];
    int np = 0;
    for (int w = 0; w < writers; w++) {
      pid_t p = fork();
      if (p == 0) _exit(writer_proc(pool, w, 64, w == 0 /*victim*/));
      pids[np++] = p;
    }
    for (int r = 0; r < writers; r++) {
      pid_t p = fork();
      if (p == 0) _exit(reader_proc(pool, writers, 256));
      pids[np++] = p;
    }
    int failures = 0, killed = 0;
    for (int i = 0; i < np; i++) {
      int st = 0;
      waitpid(pids[i], &st, 0);
      if (WIFSIGNALED(st) && WTERMSIG(st) == SIGKILL) killed++;
      else if (!WIFEXITED(st) || WEXITSTATUS(st) != 0) failures++;
    }
    if (killed != 1 || failures != 0) {
      fprintf(stderr, "round %d: failures=%d killed=%d\n", round, failures,
              killed);
      store_destroy(pool);
      return 1;
    }

    // Invariants after the crash: the pool still serves create/seal/
    // get/delete (robust-mutex recovery), and alloc/free round-trips.
    uint64_t st[8];
    store_stats(h, st);
    uint8_t id[16];
    make_id(id, 99, round);
    int32_t err = 0;
    uint64_t off = store_create_object(h, id, 1 << 16, &err);
    if (!off) { fprintf(stderr, "post-crash create failed\n"); return 1; }
    if (store_seal(h, id) != 0) { fprintf(stderr, "seal failed\n"); return 1; }
    uint64_t goff = 0, gsz = 0;
    if (store_get(h, id, &goff, &gsz) != 0 || gsz != (1 << 16)) {
      fprintf(stderr, "post-crash get failed\n");
      return 1;
    }
    store_release(h, id);
    store_delete(h, id);
    uint64_t st2[8];
    store_stats(h, st2);
    if (st2[1] < st[1]) { /* freed at least our block: fine */ }
    if (st2[2] > st[2]) {
      fprintf(stderr, "object count grew across a full round trip\n");
      return 1;
    }
    store_detach(h);
    store_destroy(pool);
  }
  printf("stress OK: %d rounds, %d writers (+%d readers), 1 SIGKILL/round\n",
         rounds, writers, writers);
  return 0;
}
