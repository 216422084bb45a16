// Shared-memory object-store core (plasma equivalent, C++).
//
// The reference's plasma store (src/ray/object_manager/plasma/store.h,
// plasma_allocator.h + vendored dlmalloc) manages mmap arenas with a
// malloc-style allocator, an object table with per-object refcounts and
// states (created → sealed), and LRU eviction of sealed, unreferenced
// objects. This is the same design collapsed into one shm pool shared
// by every process on the node:
//
//   [Header | client slots | client ledgers | object table | arena]
//
// All cross-process state lives in the pool; a robust process-shared
// pthread mutex guards the table + allocator, so a crashed worker can
// never wedge the store. Data payloads are written/read directly by
// Python through a zero-copy memoryview of the same mapping — this
// library owns METADATA AND ALLOCATION only, which is where the Python
// implementation (one shm segment + 3 syscalls per object) loses.
//
// Allocator: segregated-free-list-free classic boundary-tag malloc
// (header+footer per block, explicit doubly-linked free list,
// first-fit with splitting and bidirectional coalescing), 64-byte
// alignment so payloads are cache-line- and dlpack-friendly.
//
// Client registry (v2): every attaching process registers a client slot
// {pid, generation} and its refcount mutations are double-entried into a
// per-client ledger (open-addressed, keyed by object-table slot). The
// reference's plasma store gets disconnect sweeps for free because each
// client holds a unix socket to the store and EOF triggers
// ReleaseClientResources; with direct shm attach there is no socket, so
// the sweep walks the registry, probes liveness with kill(pid, 0), and
// subtracts a dead client's ledger from the global refcounts — including
// reclaiming its mid-write (created-not-sealed) objects, which must
// never seal. A full ledger counts overflow events (counted, never
// silent) and those refs stay pinned until pool destroy.

#include <algorithm>
#include <cerrno>
#include <csignal>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <utility>
#include <vector>

namespace {

// v2 layout (client registry + ledgers). Bumped from the v1 value so an
// old .so can never attach a new pool (or vice versa) and misread the
// table: attach checks magic and fails cleanly.
constexpr uint64_t kMagic = 0x52545055504F4F32ULL;  // "RTPUPOO2"
constexpr uint64_t kNull = ~0ULL;
constexpr uint64_t kAlign = 64;
constexpr uint64_t kBlockHeader = 16;  // [size u64][flags u64]
constexpr uint64_t kBlockFooter = 8;   // [size u64]
constexpr uint64_t kMinBlock = 128;
constexpr uint32_t kMaxClients = 256;
constexpr uint32_t kStateEmpty = 0;
constexpr uint32_t kStateCreated = 1;
constexpr uint32_t kStateSealed = 2;
constexpr uint32_t kStateTombstone = 3;
// Deleted while referenced: invisible to get/contains, freed by the
// last store_release (independent of eviction, which may be disabled).
constexpr uint32_t kStateDeleting = 4;

struct Entry {
  uint8_t id[16];
  uint64_t offset;  // arena-relative payload offset
  uint64_t size;
  uint32_t state;
  int32_t refcount;
  uint64_t lru;
  uint32_t creator;  // client slot + 1; 0 = unregistered creator
  uint32_t _pad;
};

struct ClientSlot {
  int32_t pid;
  uint32_t state;  // 0 free, 1 active
  uint64_t generation;
  uint32_t overflow;  // refs this client could not ledger (counted)
  uint32_t _pad;
  uint64_t _pad2;
};

// One per-client ledger cell: key = object-table slot + 1 (0 = empty),
// count = refs this client holds on that entry. A cell whose count
// dropped to 0 keeps its key but is reusable by any insert — losing a
// zero-count key carries no information, and probes only stop on key==0,
// so chains through reused cells stay reachable.
struct LedgerEntry {
  uint32_t key;
  uint32_t count;
};

struct Header {
  uint64_t magic;
  uint64_t pool_size;
  uint32_t evict_enabled;  // 0: full pool fails create (caller falls back)
  uint32_t _pad0;
  uint64_t table_offset;
  uint64_t arena_offset;
  uint64_t arena_size;
  uint32_t max_objects;
  uint32_t _pad;
  pthread_mutex_t mutex;
  uint64_t lru_clock;
  uint64_t free_head;  // arena-relative offset of first free block
  // client registry
  uint64_t clients_offset;
  uint64_t ledgers_offset;
  uint32_t max_clients;
  uint32_t ledger_cap;  // cells per client ledger
  uint64_t generation;  // monotonically increasing client registrations
  // stats
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t bytes_evicted;
  uint64_t num_sweeps;
  uint64_t refs_swept;
  uint64_t partials_reclaimed;
  uint64_t ledger_overflows;
};

struct Store {
  uint8_t* base;
  Header* h;
  uint64_t map_size;
  int32_t client;  // this handle's registered client slot, -1 if none
  int32_t pid;     // pid recorded at registration (slot-reuse guard)
  char name[256];
};

inline Entry* table(Store* s) {
  return reinterpret_cast<Entry*>(s->base + s->h->table_offset);
}
inline uint8_t* arena(Store* s) { return s->base + s->h->arena_offset; }
inline ClientSlot* clients(Store* s) {
  return reinterpret_cast<ClientSlot*>(s->base + s->h->clients_offset);
}
inline LedgerEntry* ledger(Store* s, uint32_t client) {
  return reinterpret_cast<LedgerEntry*>(s->base + s->h->ledgers_offset) +
         (uint64_t)client * s->h->ledger_cap;
}

// ---------------------------------------------------------------- blocks
// Block layout: [size u64][flags u64][payload ...][size u64]
// flags bit0 = allocated. Free blocks keep next/prev (arena offsets) in
// the first 16 payload bytes.
inline uint64_t blk_size(Store* s, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(arena(s) + off);
}
inline uint64_t blk_flags(Store* s, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(arena(s) + off + 8);
}
inline void blk_set(Store* s, uint64_t off, uint64_t size, uint64_t flags) {
  *reinterpret_cast<uint64_t*>(arena(s) + off) = size;
  *reinterpret_cast<uint64_t*>(arena(s) + off + 8) = flags;
  *reinterpret_cast<uint64_t*>(arena(s) + off + size - kBlockFooter) = size;
}
inline uint64_t& blk_next(Store* s, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(arena(s) + off + kBlockHeader);
}
inline uint64_t& blk_prev(Store* s, uint64_t off) {
  return *reinterpret_cast<uint64_t*>(arena(s) + off + kBlockHeader + 8);
}

void freelist_insert(Store* s, uint64_t off) {
  blk_next(s, off) = s->h->free_head;
  blk_prev(s, off) = kNull;
  if (s->h->free_head != kNull) blk_prev(s, s->h->free_head) = off;
  s->h->free_head = off;
}

void freelist_remove(Store* s, uint64_t off) {
  uint64_t n = blk_next(s, off), p = blk_prev(s, off);
  if (p != kNull) blk_next(s, p) = n; else s->h->free_head = n;
  if (n != kNull) blk_prev(s, n) = p;
}

uint64_t round_up(uint64_t v, uint64_t a) { return (v + a - 1) / a * a; }

// Returns arena-relative PAYLOAD offset or kNull.
uint64_t arena_alloc(Store* s, uint64_t payload) {
  uint64_t need = round_up(payload + kBlockHeader + kBlockFooter, kAlign);
  if (need < kMinBlock) need = kMinBlock;
  for (uint64_t off = s->h->free_head; off != kNull; off = blk_next(s, off)) {
    uint64_t sz = blk_size(s, off);
    if (sz < need) continue;
    freelist_remove(s, off);
    if (sz - need >= kMinBlock) {  // split
      blk_set(s, off + need, sz - need, 0);
      freelist_insert(s, off + need);
      blk_set(s, off, need, 1);
    } else {
      blk_set(s, off, sz, 1);
    }
    s->h->bytes_in_use += blk_size(s, off);
    return off + kBlockHeader;
  }
  return kNull;
}

void arena_free(Store* s, uint64_t payload_off) {
  uint64_t off = payload_off - kBlockHeader;
  uint64_t sz = blk_size(s, off);
  s->h->bytes_in_use -= sz;
  // Coalesce with next block.
  uint64_t next = off + sz;
  if (next < s->h->arena_size && (blk_flags(s, next) & 1) == 0) {
    freelist_remove(s, next);
    sz += blk_size(s, next);
  }
  // Coalesce with previous block (via its footer).
  if (off > 0) {
    uint64_t prev_sz = *reinterpret_cast<uint64_t*>(arena(s) + off - kBlockFooter);
    uint64_t prev = off - prev_sz;
    if ((blk_flags(s, prev) & 1) == 0) {
      freelist_remove(s, prev);
      off = prev;
      sz += prev_sz;
    }
  }
  blk_set(s, off, sz, 0);
  freelist_insert(s, off);
}

// ----------------------------------------------------------------- table
uint64_t hash_id(const uint8_t* id) {
  uint64_t h;
  std::memcpy(&h, id, 8);
  uint64_t l;
  std::memcpy(&l, id + 8, 8);
  h ^= l * 0x9E3779B97F4A7C15ULL;
  h ^= h >> 31;
  return h;
}

Entry* find_entry(Store* s, const uint8_t* id, bool for_insert) {
  uint32_t cap = s->h->max_objects;
  uint64_t idx = hash_id(id) % cap;
  Entry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < cap; ++probe) {
    Entry* e = &table(s)[(idx + probe) % cap];
    if (e->state == kStateEmpty) {
      return for_insert ? (first_tomb ? first_tomb : e) : nullptr;
    }
    if (e->state == kStateTombstone) {
      if (for_insert && !first_tomb) first_tomb = e;
      continue;
    }
    if (std::memcmp(e->id, id, 16) == 0) return e;
  }
  return for_insert ? first_tomb : nullptr;
}

void lock(Store* s) {
  int rc = pthread_mutex_lock(&s->h->mutex);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&s->h->mutex);
}
void unlock(Store* s) { pthread_mutex_unlock(&s->h->mutex); }

void free_entry(Store* s, Entry* e) {
  arena_free(s, e->offset);
  e->state = kStateTombstone;
  e->offset = kNull;
  e->creator = 0;
  s->h->num_objects--;
}

// --------------------------------------------------------------- ledgers
// Double-entry of this handle's refcount mutations, so a dead client's
// refs can be subtracted back out. Called with the pool mutex held.
void ledger_adjust(Store* s, Entry* e, int32_t delta) {
  if (s->client < 0) return;
  // Slot-reuse guard: after a sweep or a sibling handle's detach retired
  // this slot (and possibly another process re-registered it), a stale
  // handle must not touch the ledger — the global refcount alone stays
  // correct for it.
  ClientSlot* c = &clients(s)[s->client];
  if (c->state != 1 || c->pid != s->pid) {
    s->client = -1;
    return;
  }
  uint32_t ti = (uint32_t)(e - table(s));
  uint32_t key = ti + 1;
  uint32_t cap = s->h->ledger_cap;
  LedgerEntry* led = ledger(s, (uint32_t)s->client);
  uint64_t idx = ((uint64_t)ti * 0x9E3779B1ULL) % cap;
  LedgerEntry* reuse = nullptr;
  for (uint32_t p = 0; p < cap; ++p) {
    LedgerEntry* le = &led[(idx + p) % cap];
    if (le->key == key) {
      if (delta > 0) {
        le->count += (uint32_t)delta;
      } else if (le->count > 0) {
        le->count--;
      }
      return;
    }
    if (le->key == 0) {
      if (!reuse) reuse = le;
      break;
    }
    if (le->count == 0 && !reuse) reuse = le;
  }
  if (delta <= 0) return;  // release of an untracked (overflowed) ref
  if (reuse) {
    reuse->key = key;
    reuse->count = (uint32_t)delta;
    return;
  }
  // Ledger full: the global refcount is still correct while this client
  // lives, but the ref can't be swept if it dies. Counted, never silent.
  clients(s)[s->client].overflow++;
  s->h->ledger_overflows++;
}

// Subtract client `ci`'s ledger from the global refcounts and retire the
// slot. Reclaims its mid-write (created, unsealed) objects — which must
// never seal — and completes any deferred deletes its refs were pinning.
// Called with the mutex held.
uint64_t drain_client_locked(Store* s, uint32_t ci, uint64_t* partials) {
  LedgerEntry* led = ledger(s, ci);
  uint64_t dropped = 0;
  for (uint32_t j = 0; j < s->h->ledger_cap; ++j) {
    LedgerEntry* le = &led[j];
    if (le->key == 0) continue;
    if (le->count == 0) {
      le->key = 0;
      continue;
    }
    Entry* e = &table(s)[le->key - 1];
    if (e->state != kStateEmpty && e->state != kStateTombstone) {
      int32_t c = (int32_t)le->count;
      e->refcount = e->refcount > c ? e->refcount - c : 0;
      dropped += (uint64_t)c;
      if (e->state == kStateCreated && e->creator == ci + 1) {
        // Partial write by a dead creator: reclaim, never seal.
        free_entry(s, e);
        if (partials) (*partials)++;
      } else if (e->refcount == 0 && e->state == kStateDeleting) {
        free_entry(s, e);
      }
    }
    le->key = 0;
    le->count = 0;
  }
  ClientSlot* c = &clients(s)[ci];
  c->state = 0;
  c->pid = 0;
  c->overflow = 0;
  return dropped;
}

// Probe every registered client with kill(pid, 0); drain the dead ones.
// EPERM means "exists, not ours" — only ESRCH is death. A recycled pid
// pins refs until the recycled process also exits; conservative, never
// frees early. Called with the mutex held.
int32_t sweep_locked(Store* s, uint64_t* out4) {
  int32_t swept = 0;
  uint64_t refs = 0, partials = 0;
  for (uint32_t i = 0; i < s->h->max_clients; ++i) {
    ClientSlot* c = &clients(s)[i];
    if (c->state != 1) continue;
    if ((int32_t)i == s->client) continue;  // never sweep self
    if (!(kill((pid_t)c->pid, 0) != 0 && errno == ESRCH)) continue;
    refs += drain_client_locked(s, i, &partials);
    swept++;
  }
  if (swept) {
    s->h->num_sweeps++;
    s->h->refs_swept += refs;
    s->h->partials_reclaimed += partials;
  }
  if (out4) {
    out4[0] = (uint64_t)swept;
    out4[1] = refs;
    out4[2] = partials;
    out4[3] = s->h->ledger_overflows;
  }
  return swept;
}

// Evict sealed refcount-0 objects (LRU first) until at least `need`
// payload bytes can be allocated. Returns payload offset or kNull.
uint64_t alloc_with_eviction(Store* s, uint64_t need) {
  uint64_t off = arena_alloc(s, need);
  while (off == kNull && s->h->evict_enabled) {
    Entry* victim = nullptr;
    uint32_t cap = s->h->max_objects;
    for (uint32_t i = 0; i < cap; ++i) {
      Entry* e = &table(s)[i];
      if (e->state == kStateSealed && e->refcount == 0) {
        if (!victim || e->lru < victim->lru) victim = e;
      }
    }
    if (!victim) return kNull;
    s->h->num_evictions++;
    s->h->bytes_evicted += victim->size;
    free_entry(s, victim);
    off = arena_alloc(s, need);
  }
  return off;
}

}  // namespace

extern "C" {

// Create a new pool. Returns handle (opaque ptr) or 0 on failure.
// evict_enabled=0 is the safe default for a session pool: the spill
// ladder (not LRU eviction) is what frees space, so a full pool fails
// the create and the caller backpressures / falls back to per-object
// segments.
uint64_t store_create(const char* name, uint64_t pool_bytes,
                      uint32_t max_objects, int32_t evict_enabled) {
  // Ledger capacity: enough cells that a well-behaved client (refs ≤
  // objects it touches) rarely overflows, without dominating small test
  // pools. 256 clients * 4096 cells * 8 B = 8 MiB at the default cap.
  uint32_t ledger_cap = max_objects < 4096 ? max_objects : 4096;
  if (ledger_cap < 16) ledger_cap = 16;
  uint64_t clients_bytes =
      round_up((uint64_t)kMaxClients * sizeof(ClientSlot), kAlign);
  uint64_t ledgers_bytes = round_up(
      (uint64_t)kMaxClients * ledger_cap * sizeof(LedgerEntry), kAlign);
  uint64_t table_bytes = round_up((uint64_t)max_objects * sizeof(Entry), kAlign);
  uint64_t header_bytes = round_up(sizeof(Header), kAlign);
  uint64_t total = round_up(
      header_bytes + clients_bytes + ledgers_bytes + table_bytes + pool_bytes,
      4096);

  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return 0;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return 0;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return 0;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->map_size = total;
  s->client = -1;
  s->pid = 0;
  std::snprintf(s->name, sizeof(s->name), "%s", name);
  Header* h = s->h = reinterpret_cast<Header*>(base);
  h->pool_size = total;
  h->clients_offset = header_bytes;
  h->ledgers_offset = header_bytes + clients_bytes;
  h->table_offset = h->ledgers_offset + ledgers_bytes;
  h->arena_offset = h->table_offset + table_bytes;
  h->arena_size = total - h->arena_offset;
  h->max_objects = max_objects;
  h->max_clients = kMaxClients;
  h->ledger_cap = ledger_cap;
  h->generation = 0;
  h->lru_clock = 1;
  h->evict_enabled = (uint32_t)evict_enabled;
  h->free_head = kNull;
  h->bytes_in_use = 0;
  h->num_objects = 0;
  h->num_sweeps = 0;
  h->refs_swept = 0;
  h->partials_reclaimed = 0;
  h->ledger_overflows = 0;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  std::memset(s->base + h->clients_offset, 0,
              clients_bytes + ledgers_bytes + table_bytes);
  // One big free block spanning the arena.
  blk_set(s, 0, h->arena_size, 0);
  freelist_insert(s, 0);
  h->magic = kMagic;  // last: attachers spin on magic
  return reinterpret_cast<uint64_t>(s);
}

uint64_t store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return 0;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return 0;
  }
  void* base =
      mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return 0;
  Header* h = reinterpret_cast<Header*>(base);
  if (h->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    return 0;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->h = h;
  s->map_size = (size_t)st.st_size;
  s->client = -1;
  s->pid = 0;
  std::snprintf(s->name, sizeof(s->name), "%s", name);
  return reinterpret_cast<uint64_t>(s);
}

// Register this process in the client registry so its refs are sweepable
// if it dies uncleanly. Idempotent per pid (a second handle in the same
// process shares the slot and ledger). Returns the slot, or -1 when the
// registry is full even after draining dead clients.
int32_t store_register(uint64_t handle, int32_t pid) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  for (int pass = 0; pass < 2; ++pass) {
    int32_t free_slot = -1;
    for (uint32_t i = 0; i < s->h->max_clients; ++i) {
      ClientSlot* c = &clients(s)[i];
      if (c->state == 1 && c->pid == pid) {
        s->client = (int32_t)i;
        s->pid = pid;
        unlock(s);
        return (int32_t)i;
      }
      if (c->state == 0 && free_slot < 0) free_slot = (int32_t)i;
    }
    if (free_slot >= 0) {
      ClientSlot* c = &clients(s)[free_slot];
      c->pid = pid;
      c->state = 1;
      c->generation = ++s->h->generation;
      c->overflow = 0;
      std::memset(ledger(s, (uint32_t)free_slot), 0,
                  (uint64_t)s->h->ledger_cap * sizeof(LedgerEntry));
      s->client = free_slot;
      s->pid = pid;
      unlock(s);
      return free_slot;
    }
    if (pass == 0) sweep_locked(s, nullptr);  // registry full: evict the dead
  }
  unlock(s);
  return -1;
}

// Drain dead clients' refs. out4 (may be NULL): [clients_swept,
// refs_dropped, partials_reclaimed, ledger_overflows_total].
int32_t store_sweep(uint64_t handle, uint64_t* out4) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int32_t n = sweep_locked(s, out4);
  unlock(s);
  return n;
}

// Returns ABSOLUTE payload offset within the mapping (for Python's
// memoryview slicing), or 0 on failure (0 is inside the header, never a
// valid payload). err: 1 = exists, 2 = full, 3 = table full.
uint64_t store_create_object(uint64_t handle, const uint8_t* id, uint64_t size,
                             int32_t* err) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* existing = find_entry(s, id, false);
  if (existing) {
    unlock(s);
    if (err) *err = 1;
    return 0;
  }
  Entry* e = find_entry(s, id, true);
  if (!e) {
    unlock(s);
    if (err) *err = 3;
    return 0;
  }
  uint64_t off = alloc_with_eviction(s, size ? size : 1);
  if (off == kNull) {
    unlock(s);
    if (err) *err = 2;
    return 0;
  }
  std::memcpy(e->id, id, 16);
  e->offset = off;
  e->size = size;
  e->state = kStateCreated;
  e->refcount = 1;  // creator holds a ref until seal+release
  e->lru = s->h->lru_clock++;
  e->creator = s->client >= 0 ? (uint32_t)s->client + 1 : 0;
  ledger_adjust(s, e, 1);
  s->h->num_objects++;
  unlock(s);
  if (err) *err = 0;
  return s->h->arena_offset + off;
}

int32_t store_seal(uint64_t handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* e = find_entry(s, id, false);
  if (e && e->state == kStateDeleting) {
    // Deleted mid-write: drop the creator ref; last ref frees the block.
    if (e->refcount > 0) e->refcount--;
    ledger_adjust(s, e, -1);
    if (e->refcount == 0) free_entry(s, e);
    unlock(s);
    return -1;
  }
  if (!e || e->state != kStateCreated) {
    unlock(s);
    return -1;
  }
  e->state = kStateSealed;
  e->refcount -= 1;
  ledger_adjust(s, e, -1);
  unlock(s);
  return 0;
}

// Get a sealed object: bumps refcount. Returns 0 on success.
int32_t store_get(uint64_t handle, const uint8_t* id, uint64_t* abs_offset,
                  uint64_t* size) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* e = find_entry(s, id, false);
  if (!e || e->state != kStateSealed) {
    unlock(s);
    return -1;
  }
  e->refcount++;
  ledger_adjust(s, e, 1);
  e->lru = s->h->lru_clock++;
  *abs_offset = s->h->arena_offset + e->offset;
  *size = e->size;
  unlock(s);
  return 0;
}

int32_t store_contains(uint64_t handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* e = find_entry(s, id, false);
  int32_t ok = (e && e->state == kStateSealed) ? 1 : 0;
  unlock(s);
  return ok;
}

int32_t store_release(uint64_t handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* e = find_entry(s, id, false);
  if (!e || e->state == kStateEmpty || e->state == kStateTombstone) {
    unlock(s);
    return -1;
  }
  if (e->refcount > 0) e->refcount--;
  ledger_adjust(s, e, -1);
  if (e->refcount == 0 && e->state == kStateDeleting) free_entry(s, e);
  unlock(s);
  return 0;
}

int32_t store_delete(uint64_t handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  Entry* e = find_entry(s, id, false);
  if (!e) {
    unlock(s);
    return -1;
  }
  if (e->refcount > 0) {
    // Deferred: the last store_release frees the block (works even with
    // eviction disabled — the session pool's default).
    e->state = kStateDeleting;
    e->lru = 0;
    unlock(s);
    return 1;
  }
  free_entry(s, e);
  unlock(s);
  return 0;
}

// List sealed refcount-0 objects in LRU order until their sizes sum to
// at least `need` bytes (spill victim selection — reference:
// LocalObjectManager::SpillObjectsOfSize, local_object_manager.h:100).
// Writes up to max_out ids (16 bytes each) into out_ids; returns count.
int32_t store_lru_candidates(uint64_t handle, uint64_t need,
                             uint8_t* out_ids, int32_t max_out) {
  Store* s = reinterpret_cast<Store*>(handle);
  std::vector<std::pair<uint64_t, uint32_t>> eligible;  // (lru, slot)
  lock(s);
  for (uint32_t i = 0; i < s->h->max_objects; ++i) {
    Entry* e = &table(s)[i];
    if (e->state == kStateSealed && e->refcount == 0) {
      eligible.emplace_back(e->lru, i);
    }
  }
  std::sort(eligible.begin(), eligible.end());
  int32_t count = 0;
  uint64_t gathered = 0;
  for (auto& [lru, i] : eligible) {
    if (count >= max_out || gathered >= need) break;
    Entry* e = &table(s)[i];
    std::memcpy(out_ids + 16 * count, e->id, 16);
    gathered += e->size;
    ++count;
  }
  unlock(s);
  return count;
}

void store_stats(uint64_t handle, uint64_t* out8) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  out8[0] = s->h->arena_size;
  out8[1] = s->h->bytes_in_use;
  out8[2] = s->h->num_objects;
  out8[3] = s->h->num_evictions;
  out8[4] = s->h->bytes_evicted;
  out8[5] = s->h->pool_size;
  out8[6] = s->h->max_objects;
  out8[7] = s->h->ledger_overflows;
  unlock(s);
}

// Sweep stats snapshot: [num_sweeps, refs_swept, partials_reclaimed,
// active_clients].
void store_sweep_stats(uint64_t handle, uint64_t* out4) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  out4[0] = s->h->num_sweeps;
  out4[1] = s->h->refs_swept;
  out4[2] = s->h->partials_reclaimed;
  uint64_t active = 0;
  for (uint32_t i = 0; i < s->h->max_clients; ++i) {
    if (clients(s)[i].state == 1) active++;
  }
  out4[3] = active;
  unlock(s);
}

void store_detach(uint64_t handle) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (s->client >= 0) {
    // Clean disconnect: drain this process's own ledger so held refs
    // don't pin objects after exit. NOTE: the slot is per-pid, so all
    // handles in one process share it — detach drains them all, which
    // is safe because detach happens at process shutdown.
    lock(s);
    ClientSlot* c = &clients(s)[s->client];
    if (c->state == 1 && c->pid == s->pid) {
      drain_client_locked(s, (uint32_t)s->client, nullptr);
    }
    s->client = -1;
    unlock(s);
  }
  munmap(s->base, s->map_size);
  delete s;
}

int32_t store_destroy(const char* name) { return shm_unlink(name); }

}  // extern "C"
