// Minimal fixed-size thread pool of the async-I/O engine (aio.cpp); the
// port's copy of deepspeed_tpu/csrc/threadpool.h (the role of the
// reference's csrc/aio/py_lib/deepspeed_aio_thread.cpp pool).
#pragma once

#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace dstpu {

class ThreadPool {
 public:
  explicit ThreadPool(int num_threads) : stop_(false) {
    if (num_threads < 1) num_threads = 1;
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
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

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

}  // namespace dstpu
