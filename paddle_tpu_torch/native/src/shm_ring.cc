// Shared-memory ring buffer for multiprocess DataLoader transport.
//
// Role parity: the reference's DataLoader shared-memory tensor transport
// (paddle/fluid/memory/allocation/mmap_allocator.cc + the C++ blocking queue
// behind create_py_reader_op). Worker processes serialize batches into
// fixed-size slots of a POSIX shm segment; the trainer process pops them
// without touching the Python pickle path under the GIL.
//
// Layout: [Header][slot_size * n_slots]
//   Header: process-shared mutex+conds, head/tail indices, per-slot lengths.
// Blocking push/pop with timeouts; single segment, multiple producers, one
// consumer.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  uint64_t n_slots;
  uint64_t slot_size;
  uint64_t head;  // next slot to pop
  uint64_t tail;  // next slot to push
  uint64_t count;
  int32_t closed;
  // variable: uint64_t lengths[n_slots];
};

inline uint64_t* slot_lengths(Header* h) {
  return reinterpret_cast<uint64_t*>(h + 1);
}

inline char* slot_data(Header* h, uint64_t idx) {
  char* base = reinterpret_cast<char*>(h + 1) + h->n_slots * sizeof(uint64_t);
  return base + idx * h->slot_size;
}

uint64_t total_bytes(uint64_t n_slots, uint64_t slot_size) {
  return sizeof(Header) + n_slots * sizeof(uint64_t) + n_slots * slot_size;
}

void make_abstime(struct timespec* ts, double timeout_s) {
  clock_gettime(CLOCK_REALTIME, ts);
  time_t sec = static_cast<time_t>(timeout_s);
  long nsec = static_cast<long>((timeout_s - sec) * 1e9);
  ts->tv_sec += sec;
  ts->tv_nsec += nsec;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Create a new ring; returns mapped header or nullptr.
void* shm_ring_create(const char* name, uint64_t n_slots,
                      uint64_t slot_size) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t bytes = total_bytes(n_slots, slot_size);
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  memset(h, 0, sizeof(Header));
  h->n_slots = n_slots;
  h->slot_size = slot_size;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->not_empty, &ca);
  pthread_cond_init(&h->not_full, &ca);
  return mem;
}

// Attach to an existing ring.
void* shm_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  return mem == MAP_FAILED ? nullptr : mem;
}

static int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

// Push one message. Returns 0 ok, -1 timeout, -2 closed, -3 too large.
int shm_ring_push(void* ring, const char* data, uint64_t len,
                  double timeout_s) {
  Header* h = static_cast<Header*>(ring);
  if (len > h->slot_size) return -3;
  struct timespec ts;
  make_abstime(&ts, timeout_s);
  if (lock_robust(h) != 0) return -1;
  while (h->count == h->n_slots && !h->closed) {
    if (pthread_cond_timedwait(&h->not_full, &h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint64_t idx = h->tail;
  memcpy(slot_data(h, idx), data, len);
  slot_lengths(h)[idx] = len;
  h->tail = (h->tail + 1) % h->n_slots;
  h->count += 1;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Pop one message into out (cap out_cap). Returns length, -1 timeout,
// -2 closed+empty, -3 buffer too small.
int64_t shm_ring_pop(void* ring, char* out, uint64_t out_cap,
                     double timeout_s) {
  Header* h = static_cast<Header*>(ring);
  struct timespec ts;
  make_abstime(&ts, timeout_s);
  if (lock_robust(h) != 0) return -1;
  while (h->count == 0 && !h->closed) {
    if (pthread_cond_timedwait(&h->not_empty, &h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->count == 0 && h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint64_t idx = h->head;
  uint64_t len = slot_lengths(h)[idx];
  if (len > out_cap) {
    pthread_mutex_unlock(&h->mu);
    return -3;
  }
  memcpy(out, slot_data(h, idx), len);
  h->head = (h->head + 1) % h->n_slots;
  h->count -= 1;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len);
}

uint64_t shm_ring_slot_size(void* ring) {
  return static_cast<Header*>(ring)->slot_size;
}

uint64_t shm_ring_count(void* ring) {
  Header* h = static_cast<Header*>(ring);
  return h->count;
}

void shm_ring_close(void* ring) {
  Header* h = static_cast<Header*>(ring);
  if (lock_robust(h) != 0) return;
  h->closed = 1;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mu);
}

void shm_ring_detach(void* ring) {
  Header* h = static_cast<Header*>(ring);
  munmap(ring, total_bytes(h->n_slots, h->slot_size));
}

void shm_ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
