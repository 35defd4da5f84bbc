// Native prefetching stereo-frame loader (C ABI, loaded via ctypes).
//
// The reference's Examples/*.cc mains read images synchronously with
// cv::imread in the tracking loop; at accelerator frame rates (>100 fps) the
// decode becomes the bottleneck.  This loader owns a worker-thread pool
// that decodes frames ahead of the consumer into a bounded ring of
// preallocated grayscale buffers — the host-side "dataloader" limb of
// the runtime.

#include <atomic>
#include <memory>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Slot {
  std::vector<uint8_t> left, right;
  long index = -1;
  std::atomic<bool> ready{false};
};

struct Loader {
  std::vector<std::string> lefts, rights;
  int height = 0, width = 0;
  std::vector<std::unique_ptr<Slot>> ring;
  std::atomic<long> next_to_decode{0};
  long next_to_consume = 0;  // guarded by mu
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      long idx = next_to_decode.fetch_add(1);
      if (stop.load() || idx >= (long)lefts.size()) return;
      Slot& slot = *ring[idx % ring.size()];
      // Wait until the slot is free AND the consumer is close enough
      // that filling it cannot clobber an unread frame.
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() ||
                 (slot.index < 0 && idx < next_to_consume + (long)ring.size());
        });
        if (stop.load()) return;
      }
      cv::Mat l = cv::imread(lefts[idx], cv::IMREAD_GRAYSCALE);
      cv::Mat r = cv::imread(rights[idx], cv::IMREAD_GRAYSCALE);
      if (l.empty() || r.empty() || l.rows != height || l.cols != width) {
        slot.left.assign((size_t)height * width, 0);
        slot.right.assign((size_t)height * width, 0);
      } else {
        slot.left.assign(l.data, l.data + (size_t)height * width);
        slot.right.assign(r.data, r.data + (size_t)height * width);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot.index = idx;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** left_paths, const char** right_paths,
                    long n, int height, int width, int n_workers,
                    int ring_size) {
  auto* ld = new Loader();
  ld->height = height;
  ld->width = width;
  for (long i = 0; i < n; i++) {
    ld->lefts.emplace_back(left_paths[i]);
    ld->rights.emplace_back(right_paths[i]);
  }
  int rs = ring_size > 0 ? ring_size : 8;
  for (int i = 0; i < rs; i++) {
    ld->ring.emplace_back(new Slot());
    ld->ring.back()->left.resize((size_t)height * width);
    ld->ring.back()->right.resize((size_t)height * width);
  }
  int nw = n_workers > 0 ? n_workers : 2;
  for (int i = 0; i < nw; i++)
    ld->workers.emplace_back([ld] { ld->worker(); });
  return ld;
}

// Copy frame `idx` into out buffers (uint8 [height*width] each).
// Blocks until decoded. Returns 0 on success.
int loader_get(void* handle, long idx, uint8_t* out_left,
               uint8_t* out_right) {
  auto* ld = (Loader*)handle;
  if (idx >= (long)ld->lefts.size()) return -1;
  Slot& slot = *ld->ring[idx % ld->ring.size()];
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv.wait(lk, [&] { return ld->stop.load() || slot.index == idx; });
    if (ld->stop.load()) return -1;
  }
  size_t sz = (size_t)ld->height * ld->width;
  std::memcpy(out_left, slot.left.data(), sz);
  std::memcpy(out_right, slot.right.data(), sz);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    slot.index = -1;  // release the slot for re-use
    if (idx + 1 > ld->next_to_consume) ld->next_to_consume = idx + 1;
  }
  ld->cv.notify_all();
  return 0;
}

void loader_destroy(void* handle) {
  auto* ld = (Loader*)handle;
  ld->stop.store(true);
  ld->cv.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
