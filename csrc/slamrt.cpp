// slamrt — native runtime core for orbslam2_tpu.
//
// The reference's runtime layer is C++ threads + queues + atomic flags:
// keyframe queues (LocalMapping::mlNewKeyFrames, LocalMapping.cc:114),
// interrupt flags (mbAbortBA, LocalMapping.cc:624; mbStopGBA,
// LoopClosing.cc:446), stop/release/finish handshakes
// (LocalMapping.cc:552-755), and steady-clock timing in every driver.
// This library provides the same primitives for this framework's host
// pipeline, exposed through a C ABI consumed via ctypes
// (orbslam2_tpu/runtime/native.py).  Blocking waits happen here, off the
// Python GIL.
//
// Build: make -C csrc   →  libslamrt.so

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

// ---------------------------------------------------------------- queue ----
// Bounded MPMC token queue with close semantics.  Tokens are opaque u64
// (frame ids / keyframe slots); payloads stay in Python/JAX land.
struct TokenQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<uint64_t> q;
  size_t capacity;
  bool closed = false;

  explicit TokenQueue(size_t cap) : capacity(cap) {}
};

// ----------------------------------------------------------------- flags ----
// Interrupt cell: the mbAbortBA pattern — a producer raises the flag, a
// long-running consumer polls it between optimization blocks.
struct Flag {
  std::atomic<uint32_t> v{0};
};

// ----------------------------------------------------------------- stats ----
// Lock-free-ish stage timer: record durations, query count/mean/median-ish
// (p50 via sorted copy under lock — called rarely).
struct Timer {
  std::mutex mu;
  std::vector<double> samples_ms;
  Clock::time_point t0;
};

}  // namespace

extern "C" {

// queue -----------------------------------------------------------------
void* slamrt_queue_new(uint64_t capacity) {
  return new TokenQueue(static_cast<size_t>(capacity));
}

void slamrt_queue_free(void* h) { delete static_cast<TokenQueue*>(h); }

// returns 0 on success, -1 if closed
int32_t slamrt_queue_push(void* h, uint64_t token) {
  auto* q = static_cast<TokenQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_push.wait(lk, [&] { return q->closed || q->q.size() < q->capacity; });
  if (q->closed) return -1;
  q->q.push_back(token);
  q->cv_pop.notify_one();
  return 0;
}

// non-blocking push; drops oldest when full (keyframe-queue backpressure:
// the reference instead aborts BA and catches up — callers combine this
// with an interrupt flag). returns 1 if an element was dropped.
int32_t slamrt_queue_push_latest(void* h, uint64_t token) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  if (q->closed) return -1;
  int32_t dropped = 0;
  if (q->q.size() >= q->capacity) {
    q->q.pop_front();
    dropped = 1;
  }
  q->q.push_back(token);
  q->cv_pop.notify_one();
  return dropped;
}

// blocking pop with timeout_ms (<0: infinite). returns 0 ok, -1 closed+empty,
// -2 timeout.  token written through out.
int32_t slamrt_queue_pop(void* h, int64_t timeout_ms, uint64_t* out) {
  auto* q = static_cast<TokenQueue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return !q->q.empty() || q->closed; };
  if (timeout_ms < 0) {
    q->cv_pop.wait(lk, ready);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 ready)) {
    return -2;
  }
  if (q->q.empty()) return -1;
  *out = q->q.front();
  q->q.pop_front();
  q->cv_push.notify_one();
  return 0;
}

uint64_t slamrt_queue_size(void* h) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->q.size();
}

void slamrt_queue_close(void* h) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

// flags ------------------------------------------------------------------
void* slamrt_flag_new() { return new Flag(); }
void slamrt_flag_free(void* h) { delete static_cast<Flag*>(h); }
void slamrt_flag_set(void* h, uint32_t v) {
  static_cast<Flag*>(h)->v.store(v, std::memory_order_release);
}
uint32_t slamrt_flag_get(void* h) {
  return static_cast<Flag*>(h)->v.load(std::memory_order_acquire);
}
// atomically: read current value and clear. (abort-BA consume pattern)
uint32_t slamrt_flag_consume(void* h) {
  return static_cast<Flag*>(h)->v.exchange(0, std::memory_order_acq_rel);
}

// timers -----------------------------------------------------------------
void* slamrt_timer_new() { return new Timer(); }
void slamrt_timer_free(void* h) { delete static_cast<Timer*>(h); }
void slamrt_timer_start(void* h) {
  static_cast<Timer*>(h)->t0 = Clock::now();
}
double slamrt_timer_stop(void* h) {  // returns ms, records sample
  auto* t = static_cast<Timer*>(h);
  double ms = std::chrono::duration<double, std::milli>(
                  Clock::now() - t->t0).count();
  std::lock_guard<std::mutex> lk(t->mu);
  t->samples_ms.push_back(ms);
  return ms;
}
uint64_t slamrt_timer_count(void* h) {
  auto* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  return t->samples_ms.size();
}
// stats: [mean, median, min, max] written into out[4]
void slamrt_timer_stats(void* h, double* out) {
  auto* t = static_cast<Timer*>(h);
  std::lock_guard<std::mutex> lk(t->mu);
  if (t->samples_ms.empty()) {
    out[0] = out[1] = out[2] = out[3] = 0.0;
    return;
  }
  std::vector<double> s = t->samples_ms;
  std::sort(s.begin(), s.end());
  double sum = 0;
  for (double v : s) sum += v;
  out[0] = sum / s.size();
  out[1] = s[s.size() / 2];
  out[2] = s.front();
  out[3] = s.back();
}

double slamrt_now_ms() {
  return std::chrono::duration<double, std::milli>(
             Clock::now().time_since_epoch()).count();
}

}  // extern "C"
