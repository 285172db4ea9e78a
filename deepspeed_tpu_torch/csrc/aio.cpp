// Async block file I/O for NVMe tensor swapping: the port's copy of
// deepspeed_tpu/csrc/aio.cpp (reference csrc/aio/py_lib/
// deepspeed_py_aio_handle.cpp + deepspeed_aio_thread.cpp). A C API
// (ctypes-friendly) over a thread pool that splits each request into
// block-sized chunks and runs positioned reads/writes in parallel.
//
// Parallel pread/pwrite over a pool keeps the engine portable
// (io_uring/libaio availability varies).

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>

#include "threadpool.h"

namespace {

struct Request {
  std::atomic<int64_t> remaining{0};  // bytes still in flight
  std::atomic<int64_t> status{0};     // 0 ok, else -errno of first failure
  std::mutex mu;
  std::condition_variable cv;
  bool done_flag = false;

  void finish_chunk(int64_t nbytes, int64_t err) {
    if (err != 0) {
      int64_t expected = 0;
      status.compare_exchange_strong(expected, err);
    }
    if (remaining.fetch_sub(nbytes) - nbytes <= 0) {
      std::lock_guard<std::mutex> lock(mu);
      done_flag = true;
      cv.notify_all();
    }
  }

  int64_t wait() {
    std::unique_lock<std::mutex> lock(mu);
    cv.wait(lock, [this] { return done_flag; });
    return status.load();
  }
};

struct AioHandle {
  std::unique_ptr<dstpu::ThreadPool> pool;
  int64_t block_size;
  std::mutex reqs_mu;
  std::map<int64_t, std::shared_ptr<Request>> reqs;
  std::atomic<int64_t> next_id{1};

  std::shared_ptr<Request> get(int64_t id) {
    std::lock_guard<std::mutex> lock(reqs_mu);
    auto it = reqs.find(id);
    return it == reqs.end() ? nullptr : it->second;
  }
};

// one positioned-I/O chunk; retries partial transfers
int64_t do_rw(bool write, int fd, char* buf, int64_t nbytes, int64_t offset) {
  int64_t left = nbytes;
  while (left > 0) {
    ssize_t n = write ? pwrite(fd, buf, left, offset)
                      : pread(fd, buf, left, offset);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -static_cast<int64_t>(errno);
    }
    if (n == 0) return -static_cast<int64_t>(EIO);  // unexpected EOF
    buf += n;
    offset += n;
    left -= n;
  }
  return 0;
}

int64_t submit(AioHandle* h, const char* path, void* buf, int64_t nbytes,
               int64_t file_offset, bool write) {
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  int fd = open(path, flags, 0644);
  if (fd < 0) return -static_cast<int64_t>(errno);

  auto req = std::make_shared<Request>();
  req->remaining.store(nbytes == 0 ? 1 : nbytes);
  int64_t id = h->next_id.fetch_add(1);
  {
    std::lock_guard<std::mutex> lock(h->reqs_mu);
    h->reqs[id] = req;
  }
  if (nbytes == 0) {
    close(fd);
    req->finish_chunk(1, 0);
    return id;
  }

  // split into block-sized chunks across the pool; the fd is shared
  // (positioned I/O is thread-safe) and closed by the last chunk
  auto chunks_left = std::make_shared<std::atomic<int64_t>>(
      (nbytes + h->block_size - 1) / h->block_size);
  for (int64_t off = 0; off < nbytes; off += h->block_size) {
    int64_t len = std::min(h->block_size, nbytes - off);
    char* cbuf = static_cast<char*>(buf) + off;
    int64_t foff = file_offset + off;
    h->pool->submit([=] {
      int64_t err = do_rw(write, fd, cbuf, len, foff);
      if (chunks_left->fetch_sub(1) == 1) close(fd);
      req->finish_chunk(len, err);
    });
  }
  return id;
}

}  // namespace

extern "C" {

void* dstpu_aio_create(int num_threads, int64_t block_size) {
  auto* h = new AioHandle();
  h->pool = std::make_unique<dstpu::ThreadPool>(num_threads);
  h->block_size = block_size > 0 ? block_size : (1 << 20);
  return h;
}

void dstpu_aio_destroy(void* handle) {
  delete static_cast<AioHandle*>(handle);
}

// returns request id (>0) or -errno
int64_t dstpu_aio_read(void* handle, const char* path, void* buf,
                       int64_t nbytes, int64_t file_offset) {
  return submit(static_cast<AioHandle*>(handle), path, buf, nbytes,
                file_offset, false);
}

int64_t dstpu_aio_write(void* handle, const char* path, void* buf,
                        int64_t nbytes, int64_t file_offset) {
  return submit(static_cast<AioHandle*>(handle), path, buf, nbytes,
                file_offset, true);
}

// blocks until the request completes; returns 0 or -errno; frees the slot
int64_t dstpu_aio_wait(void* handle, int64_t request_id) {
  auto* h = static_cast<AioHandle*>(handle);
  auto req = h->get(request_id);
  if (!req) return -static_cast<int64_t>(EINVAL);
  int64_t st = req->wait();
  {
    std::lock_guard<std::mutex> lock(h->reqs_mu);
    h->reqs.erase(request_id);
  }
  return st;
}

int dstpu_aio_pending(void* handle) {
  auto* h = static_cast<AioHandle*>(handle);
  std::lock_guard<std::mutex> lock(h->reqs_mu);
  return static_cast<int>(h->reqs.size());
}

}  // extern "C"
