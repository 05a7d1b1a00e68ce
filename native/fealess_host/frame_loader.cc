// Threaded RGB-D frame prefetcher — the host data pipeline.
//
// Threaded replacement for the reference's synchronous capture/IO loops
// (test/linemod_recon.cpp:44-111 RealSense loop; test/linemod_train.cpp:40-86
// file loads; test/img_series_reader.* file-list reader): a pool of decoder
// threads reads (color png/jpg, depth png) pairs from disk into a bounded
// ring of pre-allocated frame buffers, so png decode and disk IO overlap
// with device compute.  Frames are delivered strictly in order.
//
// C API (ctypes-friendly): create -> next (blocking) -> release -> destroy.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Frame {
  int64_t index = -1;
  bool ok = false;
  cv::Mat bgr;     // 8UC3, resized to target
  cv::Mat depth;   // 16UC1, resized to target
};

struct Loader {
  std::vector<std::string> color_paths;
  std::vector<std::string> depth_paths;
  int target_w = 0, target_h = 0;   // 0 = keep native size
  size_t capacity = 4;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::unique_ptr<Frame>> ready;   // min-heap by index (small N)
  int64_t next_to_decode = 0;                  // claimed by workers
  int64_t next_to_deliver = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  void Work() {
    for (;;) {
      int64_t idx;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stop || next_to_decode >= (int64_t)color_paths.size()) return;
        idx = next_to_decode++;
      }
      auto f = std::make_unique<Frame>();
      f->index = idx;
      cv::Mat bgr = cv::imread(color_paths[idx], cv::IMREAD_COLOR);
      cv::Mat depth = cv::imread(depth_paths[idx], cv::IMREAD_UNCHANGED);
      f->ok = !bgr.empty() && !depth.empty() && depth.type() == CV_16UC1;
      if (f->ok && target_w > 0 && (bgr.cols != target_w || bgr.rows != target_h)) {
        cv::resize(bgr, bgr, cv::Size(target_w, target_h));
        cv::resize(depth, depth, cv::Size(target_w, target_h), 0, 0,
                   cv::INTER_NEAREST);
      }
      f->bgr = bgr;
      f->depth = depth;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || ready.size() < capacity ||
                                       idx == next_to_deliver; });
        if (stop) return;
        ready.push_back(std::move(f));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fealess_loader_create(const char** color_paths,
                            const char** depth_paths, int n_frames,
                            int target_w, int target_h, int n_threads,
                            int capacity) {
  auto* l = new Loader();
  l->color_paths.assign(color_paths, color_paths + n_frames);
  l->depth_paths.assign(depth_paths, depth_paths + n_frames);
  l->target_w = target_w;
  l->target_h = target_h;
  l->capacity = capacity > 0 ? capacity : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    l->workers.emplace_back([l] { l->Work(); });
  return l;
}

// Blocking: copies the next in-order frame into caller buffers
// (bgr: h*w*3 u8, depth: h*w u16).  Returns 1 on success, 0 on decode
// failure for that frame, -1 when the sequence is exhausted.
int fealess_loader_next(void* handle, uint8_t* bgr_out, uint16_t* depth_out,
                        int* w_out, int* h_out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_ptr<Frame> frame;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    if (l->next_to_deliver >= (int64_t)l->color_paths.size()) return -1;
    l->cv_ready.wait(lk, [&] {
      for (auto& f : l->ready)
        if (f->index == l->next_to_deliver) return true;
      return false;
    });
    for (auto& f : l->ready)
      if (f->index == l->next_to_deliver) { frame.swap(f); break; }
    l->ready.erase(std::remove_if(l->ready.begin(), l->ready.end(),
                                  [](auto& p) { return p == nullptr; }),
                   l->ready.end());
    ++l->next_to_deliver;
  }
  l->cv_space.notify_all();
  if (!frame->ok) return 0;
  *w_out = frame->bgr.cols;
  *h_out = frame->bgr.rows;
  std::memcpy(bgr_out, frame->bgr.data,
              (size_t)frame->bgr.total() * frame->bgr.elemSize());
  std::memcpy(depth_out, frame->depth.data,
              (size_t)frame->depth.total() * frame->depth.elemSize());
  return 1;
}

void fealess_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->cv_ready.notify_all();
  l->cv_space.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
