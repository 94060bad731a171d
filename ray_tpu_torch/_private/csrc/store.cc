// store.cc — node-local shared-memory object store (plasma equivalent).
//
// The port's copy of the reference package's src/store/tpu_store.cc, kept
// byte-compatible with it (same magic, header, slot and block layout), so a
// segment written by either library reads with the other. One POSIX shm
// segment per node holds a boundary-tag arena, an open-addressing object
// index and a process-shared robust mutex; every worker process on the host
// maps the same segment by name and reads sealed objects without a broker
// process (the reference's plasma passes fds over a unix socket instead).
//
// Lifecycle semantics preserved from plasma:
//   * create → write → seal → immutable; readers only see sealed objects;
//   * get pins (refcount++), release unpins; delete only reclaims unpinned;
//   * allocation failure evicts sealed refcount==0 objects LRU-first.
//
// The segment is sized with a sparse ftruncate: the caller caps the
// capacity at the tmpfs's free bytes (a write past them is a SIGBUS).
//
// Built with g++ at first use by ray_tpu_torch/_private/native_store.py,
// whose ctypes binding consumes the C ABI at the bottom.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5450555354524532ULL;  // "TPUSTRE2"
constexpr uint32_t kIdSize = 32;                    // ObjectID padded to 32B
constexpr uint64_t kAlign = 64;                     // cacheline-aligned blocks

// ---------------------------------------------------------------- layout

struct Slot {
  uint8_t id[kIdSize];
  uint64_t offset;  // arena offset of payload
  uint64_t size;    // payload bytes
  uint64_t last_access;
  int32_t state;  // 0 empty, 1 created, 2 sealed, 3 tombstone
  int32_t refcount;
  // Owner requested deletion while readers held pins: the LAST release (from
  // ANY process) reclaims the payload. Lives in the shared segment so the
  // decision survives the requesting process (plasma defers reclamation the
  // same way).
  uint32_t delete_pending;
  uint32_t pad;
};

enum SlotState { kEmpty = 0, kCreated = 1, kSealed = 2, kTombstone = 3 };

// Block header in the arena (boundary tags for O(1) coalescing).
struct BlockHeader {
  uint64_t size;       // block size incl. header
  uint64_t prev_size;  // size of the physically-previous block (0 = first)
  uint32_t free_flag;  // 1 free, 0 used
  uint32_t pad;
  // free blocks only: doubly-linked free list, offsets from arena base
  uint64_t next_free;  // 0 = none
  uint64_t prev_free;  // 0 = none
};

struct Header {
  uint64_t magic;
  uint64_t segment_size;
  uint64_t table_slots;
  uint64_t arena_offset;  // from segment base
  uint64_t arena_size;
  uint64_t used;          // payload bytes in sealed/created objects
  uint64_t num_objects;   // created + sealed
  uint64_t lru_clock;
  uint64_t free_head;     // offset of first free block (0 = none)
  // Set when EOWNERDEAD repair found unrecoverable arena corruption: every
  // subsequent operation fails with -4 and callers fall back to the
  // in-process store rather than corrupting each other further.
  uint64_t poisoned;
  pthread_mutex_t mutex;
};

struct Store {
  Header* hdr;
  uint8_t* base;  // segment base
  Slot* slots;
  uint8_t* arena;
  char name[256];
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline uint64_t hash_id(const uint8_t* id) {
  uint64_t h = 1469598103934665603ULL;  // FNV-1a
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// ------------------------------------------------------------- free list

inline BlockHeader* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(s->arena + off);
}

void freelist_remove(Store* s, BlockHeader* b, uint64_t off) {
  if (b->prev_free)
    block_at(s, b->prev_free)->next_free = b->next_free;
  else
    s->hdr->free_head = b->next_free;
  if (b->next_free) block_at(s, b->next_free)->prev_free = b->prev_free;
}

void freelist_push(Store* s, uint64_t off) {
  BlockHeader* b = block_at(s, off);
  b->free_flag = 1;
  b->prev_free = 0;
  b->next_free = s->hdr->free_head;
  if (s->hdr->free_head) block_at(s, s->hdr->free_head)->prev_free = off;
  s->hdr->free_head = off;
}

// Coalesce `off` with free physical neighbors; returns merged offset.
uint64_t coalesce(Store* s, uint64_t off) {
  BlockHeader* b = block_at(s, off);
  // next neighbor
  uint64_t next_off = off + b->size;
  if (next_off < s->hdr->arena_size) {
    BlockHeader* n = block_at(s, next_off);
    if (n->free_flag) {
      freelist_remove(s, n, next_off);
      b->size += n->size;
      uint64_t after = off + b->size;
      if (after < s->hdr->arena_size) block_at(s, after)->prev_size = b->size;
    }
  }
  // prev neighbor
  if (b->prev_size) {
    uint64_t prev_off = off - b->prev_size;
    BlockHeader* p = block_at(s, prev_off);
    if (p->free_flag) {
      freelist_remove(s, p, prev_off);
      p->size += b->size;
      uint64_t after = prev_off + p->size;
      if (after < s->hdr->arena_size) block_at(s, after)->prev_size = p->size;
      return prev_off;
    }
  }
  return off;
}

// First-fit allocation; returns arena offset of the BLOCK, 0 on failure.
// (Block 0 is never handed out: the arena's first block starts at offset 0,
// so we reserve a sentinel block there during init.)
uint64_t arena_alloc(Store* s, uint64_t payload) {
  uint64_t need = align_up(payload + sizeof(BlockHeader), kAlign);
  uint64_t off = s->hdr->free_head;
  while (off) {
    BlockHeader* b = block_at(s, off);
    if (b->size >= need) {
      freelist_remove(s, b, off);
      b->free_flag = 0;
      uint64_t remainder = b->size - need;
      if (remainder >= align_up(sizeof(BlockHeader) + kAlign, kAlign)) {
        b->size = need;
        uint64_t rest_off = off + need;
        BlockHeader* rest = block_at(s, rest_off);
        rest->size = remainder;
        rest->prev_size = need;
        rest->next_free = rest->prev_free = 0;
        freelist_push(s, rest_off);
        uint64_t after = rest_off + remainder;
        if (after < s->hdr->arena_size) block_at(s, after)->prev_size = remainder;
      }
      return off;
    }
    off = b->next_free;
  }
  return 0;
}

void arena_free(Store* s, uint64_t off) {
  off = coalesce(s, off);
  freelist_push(s, off);
}

// ------------------------------------------------------------------ index

Slot* find_slot(Store* s, const uint8_t* id, bool for_insert) {
  uint64_t n = s->hdr->table_slots;
  uint64_t i = hash_id(id) % n;
  Slot* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < n; probe++, i = (i + 1) % n) {
    Slot* slot = &s->slots[i];
    if (slot->state == kEmpty) {
      if (!for_insert) return nullptr;
      return first_tomb ? first_tomb : slot;
    }
    if (slot->state == kTombstone) {
      if (for_insert && !first_tomb) first_tomb = slot;
      continue;
    }
    if (memcmp(slot->id, id, kIdSize) == 0) return slot;
  }
  return first_tomb;  // table full (or nullptr)
}

void evict_payload(Store* s, Slot* slot) {
  arena_free(s, slot->offset);
  s->hdr->used -= slot->size;
  s->hdr->num_objects--;
  slot->state = kTombstone;
}

// Evict sealed, unpinned objects LRU-first until `payload` allocates.
uint64_t alloc_with_eviction(Store* s, uint64_t payload) {
  uint64_t off = arena_alloc(s, payload);
  while (!off) {
    Slot* victim = nullptr;
    for (uint64_t i = 0; i < s->hdr->table_slots; i++) {
      Slot* slot = &s->slots[i];
      if (slot->state == kSealed && slot->refcount == 0 &&
          (!victim || slot->last_access < victim->last_access)) {
        victim = slot;
      }
    }
    if (!victim) return 0;  // nothing evictable
    evict_payload(s, victim);
    off = arena_alloc(s, payload);
  }
  return off;
}

// -------------------------------------------------------------- repair
//
// A worker killed while holding the robust mutex may have died mid-surgery
// (arena_alloc/coalesce/evict half-applied). pthread_mutex_consistent only
// repairs the LOCK; this rebuilds the DATA from first principles:
//   pass 1: walk physical blocks by size fields (authoritative), fixing
//           prev_size links and rebuilding the free list from free_flag;
//   pass 2: validate every occupied slot (payload within a used block);
//           invalid slots are tombstoned; used/num_objects recomputed;
//   pass 3: used blocks no valid slot points at (death between alloc and
//           slot publish) are returned to the free list.
// Any structurally-impossible size poisons the segment instead of guessing.

int repair_store(Store* s) {
  Header* h = s->hdr;
  // Pass 1: physical walk.
  h->free_head = 0;
  uint64_t off = 0;
  uint64_t prev_size = 0;
  while (off < h->arena_size) {
    BlockHeader* b = block_at(s, off);
    if (b->size < sizeof(BlockHeader) || b->size % kAlign != 0 ||
        off + b->size > h->arena_size) {
      return -1;  // unrecoverable: block chain is broken
    }
    b->prev_size = prev_size;
    b->pad = 0;  // mark bit for pass 3
    if (b->free_flag) {
      b->next_free = h->free_head;
      b->prev_free = 0;
      if (h->free_head) block_at(s, h->free_head)->prev_free = off;
      h->free_head = off;
    }
    prev_size = b->size;
    off += b->size;
  }
  if (off != h->arena_size) return -1;
  // Pass 2: slot validation + accounting rebuild.
  uint64_t used = 0;
  uint64_t num_objects = 0;
  for (uint64_t i = 0; i < h->table_slots; i++) {
    Slot* slot = &s->slots[i];
    if (slot->state != kCreated && slot->state != kSealed) continue;
    bool valid = slot->offset + sizeof(BlockHeader) + slot->size <= h->arena_size &&
                 slot->offset % kAlign == 0;
    if (valid) {
      BlockHeader* b = block_at(s, slot->offset);
      valid = !b->free_flag &&
              slot->size + sizeof(BlockHeader) <= b->size;
    }
    if (!valid) {
      slot->state = kTombstone;
      continue;
    }
    block_at(s, slot->offset)->pad = 1;
    used += slot->size;
    num_objects++;
  }
  h->used = used;
  h->num_objects = num_objects;
  // Pass 3: reclaim orphaned used blocks (skip the offset-0 sentinel).
  // Collect first, free after: arena_free coalesces, which would invalidate
  // headers ahead of an in-progress walk.
  uint64_t* orphans = new uint64_t[1024];
  uint64_t n_orphans = 0;
  uint64_t cap_orphans = 1024;
  off = 0;
  while (off < h->arena_size) {
    BlockHeader* b = block_at(s, off);
    uint64_t size = b->size;
    if (off != 0 && !b->free_flag && !b->pad) {
      if (n_orphans == cap_orphans) {
        uint64_t* bigger = new uint64_t[cap_orphans * 2];
        memcpy(bigger, orphans, n_orphans * sizeof(uint64_t));
        delete[] orphans;
        orphans = bigger;
        cap_orphans *= 2;
      }
      orphans[n_orphans++] = off;
    }
    off += size;
  }
  for (uint64_t i = 0; i < n_orphans; i++) arena_free(s, orphans[i]);
  delete[] orphans;
  return 0;
}

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

// Create (or open, if it exists) a named store. slots==0 → default.
Store* tps_open(const char* name, uint64_t capacity, uint64_t slots) {
  if (slots == 0) slots = 1 << 16;
  uint64_t table_bytes = slots * sizeof(Slot);
  uint64_t header_bytes = align_up(sizeof(Header), kAlign);
  uint64_t arena_size = align_up(capacity, kAlign);
  uint64_t segment_size =
      align_up(header_bytes + align_up(table_bytes, kAlign) + arena_size, 4096);

  bool created = false;
  int fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd >= 0) {
    created = true;
    if (ftruncate(fd, (off_t)segment_size) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else if (errno == EEXIST) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    segment_size = (uint64_t)st.st_size;
  } else {
    return nullptr;
  }

  void* base =
      mmap(nullptr, segment_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->hdr = reinterpret_cast<Header*>(base);
  snprintf(s->name, sizeof(s->name), "%s", name);

  if (created) {
    Header* h = s->hdr;
    memset(h, 0, sizeof(Header));
    h->segment_size = segment_size;
    h->table_slots = slots;
    h->arena_offset = header_bytes + align_up(table_bytes, kAlign);
    h->arena_size = segment_size - h->arena_offset;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    s->slots = reinterpret_cast<Slot*>(s->base + header_bytes);
    memset(s->slots, 0, table_bytes);
    s->arena = s->base + h->arena_offset;
    // Offset 0 doubles as the free-list null sentinel, so the arena starts
    // with a permanently-used sentinel block and the real free space begins
    // at kAlign.
    BlockHeader* sentinel = reinterpret_cast<BlockHeader*>(s->arena);
    sentinel->size = kAlign;
    sentinel->prev_size = 0;
    sentinel->free_flag = 0;
    BlockHeader* first = reinterpret_cast<BlockHeader*>(s->arena + kAlign);
    first->size = h->arena_size - kAlign;
    first->prev_size = kAlign;
    first->free_flag = 1;
    first->next_free = first->prev_free = 0;
    h->free_head = kAlign;
    __sync_synchronize();
    h->magic = kMagic;
  } else {
    // Spin briefly until the creator finishes initialization.
    for (int i = 0; i < 10000 && s->hdr->magic != kMagic; i++) usleep(100);
    if (s->hdr->magic != kMagic) {
      munmap(base, segment_size);
      delete s;
      return nullptr;
    }
    uint64_t header_bytes2 = align_up(sizeof(Header), kAlign);
    s->slots = reinterpret_cast<Slot*>(s->base + header_bytes2);
    s->arena = s->base + s->hdr->arena_offset;
  }
  return s;
}

// Returns 0 normally; -4 when the segment is poisoned (caller must unlock
// and fail the operation).
static int lock_store(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A worker died holding the lock: the lock is ours again, but the data
    // it was mutating may be half-applied. Rebuild or poison before letting
    // anyone touch the arena.
    pthread_mutex_consistent(&s->hdr->mutex);
    if (!s->hdr->poisoned && repair_store(s) != 0) s->hdr->poisoned = 1;
  }
  return s->hdr->poisoned ? -4 : 0;
}

#define LOCK_OR_FAIL(s)                        \
  do {                                         \
    if (lock_store(s) != 0) {                  \
      pthread_mutex_unlock(&(s)->hdr->mutex);  \
      return -4;                               \
    }                                          \
  } while (0)

// Allocate an object buffer; caller writes payload then calls tps_seal.
// Returns 0 ok, -1 exists, -2 out of memory, -3 table full.
int tps_create(Store* s, const uint8_t* id, uint64_t size, void** out) {
  LOCK_OR_FAIL(s);
  Slot* slot = find_slot(s, id, true);
  if (!slot) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -3;
  }
  if (slot->state == kCreated || slot->state == kSealed) {
    // -5: the old payload is awaiting a deferred delete (readers still pin
    // it) — a reseal under the same id can't succeed, the caller must store
    // elsewhere. -1: idempotent reseal of a live object.
    int rc = slot->delete_pending ? -5 : -1;
    pthread_mutex_unlock(&s->hdr->mutex);
    return rc;
  }
  uint64_t off = alloc_with_eviction(s, size);
  if (!off) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -2;
  }
  memcpy(slot->id, id, kIdSize);
  slot->offset = off;
  slot->size = size;
  slot->state = kCreated;
  slot->refcount = 0;
  slot->delete_pending = 0;
  slot->last_access = ++s->hdr->lru_clock;
  s->hdr->used += size;
  s->hdr->num_objects++;
  *out = s->arena + off + sizeof(BlockHeader);
  pthread_mutex_unlock(&s->hdr->mutex);
  return 0;
}

int tps_seal(Store* s, const uint8_t* id) {
  LOCK_OR_FAIL(s);
  Slot* slot = find_slot(s, id, false);
  int rc = 0;
  if (!slot || slot->state != kCreated)
    rc = -1;
  else
    slot->state = kSealed;
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

// One-shot put (create + copy + seal).
int tps_put(Store* s, const uint8_t* id, const void* data, uint64_t size) {
  void* dst = nullptr;
  int rc = tps_create(s, id, size, &dst);
  if (rc != 0) return rc;
  memcpy(dst, data, size);
  return tps_seal(s, id);
}

// Gather-put: create one allocation of `total` bytes, copy n buffers to
// their offsets within it (caller computes the envelope layout), seal.
// The copies run OUTSIDE the store mutex (the slot is kCreated, invisible
// to readers) and, for large payloads, striped across `nthreads` threads —
// a single memcpy stream does not saturate server memory bandwidth, which
// is what separates plasma's 19 GB/s from a naive copy loop.
int tps_put_gather(Store* s, const uint8_t* id, const void** bufs,
                   const uint64_t* lens, const uint64_t* offs, int32_t n,
                   uint64_t total, int32_t nthreads) {
  void* dst = nullptr;
  int rc = tps_create(s, id, total, &dst);
  if (rc != 0) return rc;
  uint8_t* base = reinterpret_cast<uint8_t*>(dst);
  constexpr uint64_t kStripe = 4ull << 20;  // 4 MB copy tasks
  if (nthreads <= 1 || total < 2 * kStripe) {
    for (int32_t i = 0; i < n; i++) memcpy(base + offs[i], bufs[i], lens[i]);
    return tps_seal(s, id);
  }
  // Flatten buffers into ~4MB tasks, then run them on nthreads workers.
  struct Task {
    const uint8_t* src;
    uint8_t* dst;
    uint64_t len;
  };
  std::vector<Task> tasks;
  for (int32_t i = 0; i < n; i++) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(bufs[i]);
    uint8_t* d = base + offs[i];
    uint64_t left = lens[i];
    while (left > 0) {
      uint64_t step = left < kStripe ? left : kStripe;
      tasks.push_back({src, d, step});
      src += step;
      d += step;
      left -= step;
    }
  }
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= tasks.size()) return;
      memcpy(tasks[i].dst, tasks[i].src, tasks[i].len);
    }
  };
  int32_t spawn = nthreads - 1;
  if (spawn > static_cast<int32_t>(tasks.size()) - 1)
    spawn = static_cast<int32_t>(tasks.size()) - 1;
  std::vector<std::thread> threads;
  threads.reserve(spawn);
  for (int32_t t = 0; t < spawn; t++) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return tps_seal(s, id);
}

// Pin + return payload pointer. 0 ok, -1 not found / unsealed.
int tps_get(Store* s, const uint8_t* id, const void** data, uint64_t* size) {
  LOCK_OR_FAIL(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->state != kSealed || slot->delete_pending) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -1;
  }
  slot->refcount++;
  slot->last_access = ++s->hdr->lru_clock;
  *data = s->arena + slot->offset + sizeof(BlockHeader);
  *size = slot->size;
  pthread_mutex_unlock(&s->hdr->mutex);
  return 0;
}

int tps_release(Store* s, const uint8_t* id) {
  LOCK_OR_FAIL(s);
  Slot* slot = find_slot(s, id, false);
  int rc = 0;
  if (!slot || slot->refcount <= 0) {
    rc = -1;
  } else {
    slot->refcount--;
    // Deferred owner-delete: whichever process drops the LAST pin reclaims
    // the payload (the flag lives in the shared slot, so it doesn't matter
    // which process asked for the delete or whether it is still alive).
    if (slot->refcount == 0 && slot->delete_pending) evict_payload(s, slot);
  }
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

int tps_contains(Store* s, const uint8_t* id) {
  if (lock_store(s) != 0) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return 0;
  }
  Slot* slot = find_slot(s, id, false);
  int rc = (slot && slot->state == kSealed) ? 1 : 0;
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

// Delete if unpinned (refcount 0). 0 ok, -1 not found, -2 pinned (the
// delete is recorded in the shared slot and completes on the last release,
// from whichever process holds it).
int tps_delete(Store* s, const uint8_t* id) {
  LOCK_OR_FAIL(s);
  Slot* slot = find_slot(s, id, false);
  int rc = 0;
  if (!slot || (slot->state != kSealed && slot->state != kCreated)) {
    rc = -1;
  } else if (slot->refcount > 0) {
    slot->delete_pending = 1;
    rc = -2;
  } else {
    evict_payload(s, slot);
  }
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

uint64_t tps_used(Store* s) { return s->hdr->used; }
uint64_t tps_capacity(Store* s) { return s->hdr->arena_size; }
uint64_t tps_num_objects(Store* s) { return s->hdr->num_objects; }

void tps_close(Store* s) {
  munmap(s->base, s->hdr->segment_size);
  delete s;
}

// Unlink the segment (node shutdown); existing mappings stay valid.
int tps_destroy(const char* name) { return shm_unlink(name); }

// TEST-ONLY: acquire the store mutex and return WITHOUT unlocking, so a test
// process can die while holding it and exercise the EOWNERDEAD repair path.
int tps_debug_lock(Store* s) { return pthread_mutex_lock(&s->hdr->mutex); }

int tps_poisoned(Store* s) { return s->hdr->poisoned ? 1 : 0; }

}  // extern "C"
