// dstpu_aio — asynchronous file I/O for the NVMe offload tier (DeepNVMe).
//
// Parity: reference csrc/aio: deepspeed_aio_thread.cpp's worker pool,
// py_ds_aio.cpp's aio_handle (async_pread/async_pwrite/wait), and the
// libaio/io_uring + O_DIRECT submission engines behind them
// (deepspeed_aio_common). Two engines here:
//
//  * ENGINE_THREADS (0): positional pread/pwrite on a std::thread pool —
//    portable baseline, page-cache friendly.
//  * ENGINE_URING (1): raw io_uring (no liburing dependency — setup/enter
//    syscalls + mmapped rings) submitting block-sized chunk SQEs at a
//    configurable queue depth per operation; each pooled task owns its ring
//    (no cross-thread ring locking). Optional O_DIRECT with an aligned
//    bounce buffer per in-flight chunk (the page cache is bypassed exactly
//    like the reference's O_DIRECT path; unaligned tails fall back to a
//    buffered p{read,write}).
//
// C ABI (consumed via ctypes from deepspeed_tpu_torch/ops/aio.py; a copy
// of the JAX package's csrc/aio/aio.cpp, built by ops/build.py with g++):
//   aio_handle_create(n_threads)            -> handle* (threads engine)
//   aio_handle_create_ex(n_threads, engine, odirect, block_bytes, queue_depth)
//   aio_handle_destroy(handle*)
//   aio_submit_pwrite(handle*, path, buf, nbytes, offset) -> op_id (>=0) | -errno
//   aio_submit_pread (handle*, path, buf, nbytes, offset) -> op_id (>=0) | -errno
//   aio_wait(handle*, op_id)                -> bytes transferred | -errno
//   aio_wait_all(handle*)                   -> 0 | first -errno
//   aio_pending(handle*)                    -> number of unfinished ops
//   aio_uring_supported()                   -> 1 if io_uring works here

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <future>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <stdlib.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct ThreadPool {
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop_front();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push_back(std::move(task));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::deque<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

long do_pwrite(const std::string& path, const char* buf, long nbytes,
               long offset) {
  int fd = ::open(path.c_str(), O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -errno;
  long done = 0;
  while (done < nbytes) {
    ssize_t n = ::pwrite(fd, buf + done, nbytes - done, offset + done);
    if (n < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    done += n;
  }
  ::close(fd);
  return done;
}

long do_pread(const std::string& path, char* buf, long nbytes, long offset) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return -errno;
  long done = 0;
  while (done < nbytes) {
    ssize_t n = ::pread(fd, buf + done, nbytes - done, offset + done);
    if (n < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    if (n == 0) break;  // EOF
    done += n;
  }
  ::close(fd);
  return done;
}

// ------------------------------------------------------------------------- //
// raw io_uring engine (one ring per pooled operation)
// ------------------------------------------------------------------------- //

constexpr long kAlign = 4096;  // O_DIRECT alignment (logical block upper bound)

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)::syscall(__NR_io_uring_setup, entries, p);
}
int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return (int)::syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

struct Ring {
  int fd = -1;
  unsigned entries = 0;
  // SQ
  void* sq_ptr = nullptr; size_t sq_len = 0;
  unsigned* sq_head = nullptr; unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr; unsigned* sq_array = nullptr;
  struct io_uring_sqe* sqes = nullptr; size_t sqes_len = 0;
  // CQ
  void* cq_ptr = nullptr; size_t cq_len = 0;
  unsigned* cq_head = nullptr; unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  struct io_uring_cqe* cqes = nullptr;

  int init(unsigned n) {
    struct io_uring_params p;
    ::memset(&p, 0, sizeof(p));
    fd = sys_io_uring_setup(n, &p);
    if (fd < 0) return -errno;
    entries = p.sq_entries;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
    bool single = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single) sq_len = cq_len = sq_len > cq_len ? sq_len : cq_len;
    sq_ptr = ::mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) { int e = -errno; close_all(); return e; }
    cq_ptr = single ? sq_ptr
                    : ::mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ptr == MAP_FAILED) { int e = -errno; close_all(); return e; }
    char* sq = static_cast<char*>(sq_ptr);
    sq_head = (unsigned*)(sq + p.sq_off.head);
    sq_tail = (unsigned*)(sq + p.sq_off.tail);
    sq_mask = (unsigned*)(sq + p.sq_off.ring_mask);
    sq_array = (unsigned*)(sq + p.sq_off.array);
    sqes_len = p.sq_entries * sizeof(struct io_uring_sqe);
    sqes = (struct io_uring_sqe*)::mmap(nullptr, sqes_len,
                                        PROT_READ | PROT_WRITE,
                                        MAP_SHARED | MAP_POPULATE, fd,
                                        IORING_OFF_SQES);
    if (sqes == MAP_FAILED) { int e = -errno; sqes = nullptr; close_all(); return e; }
    char* cq = static_cast<char*>(cq_ptr);
    cq_head = (unsigned*)(cq + p.cq_off.head);
    cq_tail = (unsigned*)(cq + p.cq_off.tail);
    cq_mask = (unsigned*)(cq + p.cq_off.ring_mask);
    cqes = (struct io_uring_cqe*)(cq + p.cq_off.cqes);
    return 0;
  }

  void push(bool write, int file_fd, void* addr, unsigned len, long off,
            unsigned long long user_data) {
    unsigned tail = __atomic_load_n(sq_tail, __ATOMIC_ACQUIRE);
    unsigned idx = tail & *sq_mask;
    struct io_uring_sqe* e = &sqes[idx];
    ::memset(e, 0, sizeof(*e));
    e->opcode = write ? IORING_OP_WRITE : IORING_OP_READ;
    e->fd = file_fd;
    e->addr = (unsigned long long)addr;
    e->len = len;
    e->off = (unsigned long long)off;
    e->user_data = user_data;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
  }

  // → cqe res for user_data, via caller-managed reap loop
  bool pop(long* res, unsigned long long* user_data) {
    unsigned head = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
    if (head == __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE)) return false;
    struct io_uring_cqe* c = &cqes[head & *cq_mask];
    *res = c->res;
    *user_data = c->user_data;
    __atomic_store_n(cq_head, head + 1, __ATOMIC_RELEASE);
    return true;
  }

  void close_all() {
    if (sqes) ::munmap(sqes, sqes_len);
    if (cq_ptr && cq_ptr != sq_ptr) ::munmap(cq_ptr, cq_len);
    if (sq_ptr) ::munmap(sq_ptr, sq_len);
    if (fd >= 0) ::close(fd);
    sqes = nullptr; cq_ptr = nullptr; sq_ptr = nullptr; fd = -1;
  }
  ~Ring() { close_all(); }
};

// One whole read/write as block-sized chunks at queue depth `qd`.
// O_DIRECT: every chunk stages through its own kAlign-aligned bounce buffer;
// the unaligned tail goes through a buffered fd afterwards.
long do_uring_io(bool write, const std::string& path, char* buf, long nbytes,
                 long offset, bool odirect, long block, int qd) {
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  int fd = -1;
  bool direct = odirect;
  if (direct) {
    fd = ::open(path.c_str(), flags | O_DIRECT, 0644);
    if (fd < 0) direct = false;  // fs without O_DIRECT: buffered fallback
  }
  if (fd < 0) fd = ::open(path.c_str(), flags, 0644);
  if (fd < 0) return -errno;

  if (block < kAlign) block = kAlign;
  long aligned_total = direct ? (nbytes / kAlign) * kAlign : nbytes;
  long tail_bytes = nbytes - aligned_total;

  Ring ring;
  unsigned entries = qd < 1 ? 1 : (unsigned)qd;
  int rc = ring.init(entries);
  if (rc < 0) { ::close(fd); return rc; }

  struct Chunk { char* bounce; long off; long len; };
  std::vector<Chunk> inflight(entries);
  for (auto& c : inflight) c.bounce = nullptr;

  long done_bytes = 0;
  long pos = 0;
  int err = 0;
  bool eof = false;   // reads on regular files only come back short at EOF
  unsigned live = 0;
  while ((pos < aligned_total || live > 0) && err == 0) {
    // fill the ring (stop admitting new chunks once a read saw EOF)
    unsigned pushed = 0;
    while (live < entries && pos < aligned_total && !(eof && !write)) {
      long len = std::min(block, aligned_total - pos);
      if (direct) len = (len / kAlign) * kAlign;
      // free slot = len==0 convention (bounce buffers are reused)
      unsigned slot = 0;
      for (; slot < entries; ++slot)
        if (inflight[slot].len == 0) break;
      Chunk& c = inflight[slot];
      c.off = pos; c.len = len;
      void* addr = buf + pos;
      if (direct) {
        if (!c.bounce &&
            ::posix_memalign((void**)&c.bounce, kAlign, (size_t)block) != 0) {
          err = -ENOMEM; break;
        }
        if (write) ::memcpy(c.bounce, buf + pos, (size_t)len);
        addr = c.bounce;
      }
      ring.push(write, fd, addr, (unsigned)len, offset + pos, slot);
      pos += len;
      live++; pushed++;
    }
    if (err) break;
    int ret;
    do {
      ret = sys_io_uring_enter(ring.fd, pushed, live > 0 ? 1 : 0,
                               IORING_ENTER_GETEVENTS);
      pushed = 0;   // submitted on the first (possibly interrupted) call
    } while (ret < 0 && errno == EINTR);
    if (ret < 0) { err = -errno; break; }
    long res; unsigned long long ud;
    unsigned resub = 0;
    while (ring.pop(&res, &ud)) {
      Chunk& c = inflight[ud];
      if (res == -EINTR || res == -EAGAIN) {
        // transient: resubmit the whole chunk
        void* addr = direct ? (void*)c.bounce : (void*)(buf + c.off);
        ring.push(write, fd, addr, (unsigned)c.len, offset + c.off, ud);
        resub++;
        continue;
      }
      if (res < 0) { err = (int)res; c.len = 0; live--; continue; }
      if (res < c.len) {
        if (!write) {
          // EOF (matches the threads engine's do_pread partial return)
          if (direct && res > 0)
            ::memcpy(buf + c.off, c.bounce, (size_t)res);
          done_bytes += res;
          eof = true;
          c.len = 0; live--;
          continue;
        }
        // short write: resubmit the remainder (alignment permitting)
        if (!direct || (res % kAlign) == 0) {
          if (direct) ::memmove(c.bounce, c.bounce + res, (size_t)(c.len - res));
          c.off += res; c.len -= res;
          done_bytes += res;
          void* addr = direct ? (void*)c.bounce : (void*)(buf + c.off);
          ring.push(write, fd, addr, (unsigned)c.len, offset + c.off, ud);
          resub++;
          continue;
        }
        err = -EIO;   // unaligned short O_DIRECT write: cannot continue
        c.len = 0; live--;
        continue;
      }
      if (direct && !write)
        ::memcpy(buf + c.off, c.bounce, (size_t)c.len);
      done_bytes += res;
      c.len = 0;
      live--;
    }
    if (resub > 0 && err == 0) {
      int r2;
      do {
        r2 = sys_io_uring_enter(ring.fd, resub, 0, 0);
      } while (r2 < 0 && errno == EINTR);
      if (r2 < 0) err = -errno;
    }
  }
  // error exit with SQEs still in flight: the kernel may still be writing
  // into the bounce buffers/ring — DRAIN before freeing anything (freeing
  // early would be a use-after-free). If the drain itself fails repeatedly,
  // deliberately LEAK the bounce buffers rather than corrupt the heap.
  bool leak = false;
  int drain_tries = 0;
  while (live > 0) {
    int ret = sys_io_uring_enter(ring.fd, 0, 1, IORING_ENTER_GETEVENTS);
    if (ret < 0 && errno == EINTR) continue;
    if (ret < 0 && ++drain_tries > 64) { leak = true; break; }
    long res; unsigned long long ud;
    while (ring.pop(&res, &ud)) {
      if (inflight[ud].len != 0) { inflight[ud].len = 0; live--; }
    }
  }
  if (!leak)
    for (auto& c : inflight) ::free(c.bounce);
  if (err == 0 && tail_bytes > 0) {
    // buffered tail (O_DIRECT can't express unaligned lengths)
    int tfd = ::open(path.c_str(), flags & ~O_DIRECT, 0644);
    if (tfd < 0) err = -errno;
    else {
      ssize_t n = write
          ? ::pwrite(tfd, buf + aligned_total, tail_bytes,
                     offset + aligned_total)
          : ::pread(tfd, buf + aligned_total, tail_bytes,
                    offset + aligned_total);
      if (n < 0) err = -errno; else done_bytes += n;
      ::close(tfd);
    }
  }
  ::close(fd);
  return err != 0 ? err : done_bytes;
}

struct AioHandle {
  explicit AioHandle(int n_threads, int engine = 0, int odirect = 0,
                     long block = 1 << 20, int qd = 32)
      : pool(n_threads), engine_(engine), odirect_(odirect),
        block_(block), qd_(qd), next_id(0) {}

  ThreadPool pool;
  int engine_;
  int odirect_;
  long block_;
  int qd_;
  std::mutex mu;
  std::map<int, std::future<long>> ops;
  std::atomic<int> next_id;

  int submit(std::function<long()> fn) {
    auto task = std::make_shared<std::packaged_task<long()>>(std::move(fn));
    int id = next_id.fetch_add(1);
    {
      std::lock_guard<std::mutex> lock(mu);
      ops.emplace(id, task->get_future());
    }
    pool.submit([task] { (*task)(); });
    return id;
  }
};

}  // namespace

extern "C" {

void* aio_handle_create(int n_threads) {
  if (n_threads <= 0) n_threads = 4;
  return new AioHandle(n_threads);
}

void* aio_handle_create_ex(int n_threads, int engine, int odirect,
                           long block_bytes, int queue_depth) {
  if (n_threads <= 0) n_threads = 4;
  if (block_bytes <= 0) block_bytes = 1 << 20;
  if (queue_depth <= 0) queue_depth = 32;
  return new AioHandle(n_threads, engine, odirect, block_bytes, queue_depth);
}

int aio_uring_supported() {
  struct io_uring_params p;
  ::memset(&p, 0, sizeof(p));
  int fd = sys_io_uring_setup(2, &p);
  if (fd < 0) return 0;
  ::close(fd);
  return 1;
}

void aio_handle_destroy(void* h) { delete static_cast<AioHandle*>(h); }

int aio_submit_pwrite(void* h, const char* path, const void* buf, long nbytes,
                      long offset) {
  auto* handle = static_cast<AioHandle*>(h);
  std::string p(path);
  const char* b = static_cast<const char*>(buf);
  if (handle->engine_ == 1) {
    bool od = handle->odirect_; long blk = handle->block_; int qd = handle->qd_;
    return handle->submit([p, b, nbytes, offset, od, blk, qd] {
      return do_uring_io(true, p, const_cast<char*>(b), nbytes, offset, od,
                         blk, qd);
    });
  }
  return handle->submit([p, b, nbytes, offset] {
    return do_pwrite(p, b, nbytes, offset);
  });
}

int aio_submit_pread(void* h, const char* path, void* buf, long nbytes,
                     long offset) {
  auto* handle = static_cast<AioHandle*>(h);
  std::string p(path);
  char* b = static_cast<char*>(buf);
  if (handle->engine_ == 1) {
    bool od = handle->odirect_; long blk = handle->block_; int qd = handle->qd_;
    return handle->submit([p, b, nbytes, offset, od, blk, qd] {
      return do_uring_io(false, p, b, nbytes, offset, od, blk, qd);
    });
  }
  return handle->submit([p, b, nbytes, offset] {
    return do_pread(p, b, nbytes, offset);
  });
}

long aio_wait(void* h, int op_id) {
  auto* handle = static_cast<AioHandle*>(h);
  std::future<long> fut;
  {
    std::lock_guard<std::mutex> lock(handle->mu);
    auto it = handle->ops.find(op_id);
    if (it == handle->ops.end()) return -EINVAL;
    fut = std::move(it->second);
    handle->ops.erase(it);
  }
  return fut.get();
}

int aio_wait_all(void* h) {
  auto* handle = static_cast<AioHandle*>(h);
  std::map<int, std::future<long>> pending;
  {
    std::lock_guard<std::mutex> lock(handle->mu);
    pending.swap(handle->ops);
  }
  int rc = 0;
  for (auto& kv : pending) {
    long r = kv.second.get();
    if (r < 0 && rc == 0) rc = static_cast<int>(r);
  }
  return rc;
}

int aio_pending(void* h) {
  auto* handle = static_cast<AioHandle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return static_cast<int>(handle->ops.size());
}

}  // extern "C"
