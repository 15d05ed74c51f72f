// Native asynchronous stereo/IMU data loader for pli_slam_tpu.
//
// JAX replacement for the reference's blocking ingest path: the
// CLI drivers read PNGs synchronously on the tracking thread
// (reference: Examples/Stereo-Inertial/stereo_inertial_euroc.cc:124-151,
// 203-249 — LoadImages/LoadIMU + per-frame cv::imread), stalling the
// 50 ms frame budget on disk + decode. Here a C++ worker-thread pool
// decodes ahead into a bounded ring buffer so Python/JAX always finds
// the next stereo pair (and its IMU slice) ready in pinned host memory.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image). Grayscale 8/16-bit PNGs via libpng; rectification maps can be
// applied on device (one gather), so the loader stays pure IO.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC ... -lpng -lz -lpthread).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <dirent.h>
#include <mutex>
#include <png.h>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> pixels;  // grayscale, 0..255
  bool ok = false;
};

Image decode_png_gray(const char* path) {
  Image out;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return out;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return out;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return out;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize every input to 8-bit grayscale
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.width = static_cast<int>(w);
  out.height = static_cast<int>(h);
  out.pixels.resize(static_cast<size_t>(w) * h);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out.pixels.data() + static_cast<size_t>(y) * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out.ok = true;
  return out;
}

struct FramePair {
  int64_t index = -1;
  Image left, right;
};

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> left, std::vector<std::string> right,
             int n_workers, int ring_capacity)
      : left_(std::move(left)),
        right_(std::move(right)),
        capacity_(ring_capacity),
        next_to_schedule_(0),
        next_to_emit_(0),
        stop_(false) {
    const int64_t n = static_cast<int64_t>(left_.size());
    done_.resize(n);
    for (int i = 0; i < n_workers; ++i)
      workers_.emplace_back([this] { this->WorkerLoop(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_emit_.notify_all();
    for (auto& w : workers_) w.join();
  }

  // Blocks until frame `next_to_emit_` is decoded; copies into caller
  // buffers. Returns 0 on success, -1 at end, -2 on decode failure.
  int Next(float* out_l, float* out_r, int expect_w, int expect_h) {
    std::unique_lock<std::mutex> lk(mu_);
    const int64_t want = next_to_emit_;
    if (want >= static_cast<int64_t>(left_.size())) return -1;
    cv_emit_.wait(lk, [&] { return stop_ || done_[want].index == want; });
    if (stop_) return -1;
    FramePair fp = std::move(done_[want]);
    done_[want] = FramePair{};
    ++next_to_emit_;
    lk.unlock();
    cv_work_.notify_all();

    if (!fp.left.ok || !fp.right.ok) return -2;
    if (fp.left.width != expect_w || fp.left.height != expect_h) return -3;
    std::memcpy(out_l, fp.left.pixels.data(), sizeof(float) * expect_w * expect_h);
    std::memcpy(out_r, fp.right.pixels.data(), sizeof(float) * expect_w * expect_h);
    return 0;
  }

  int64_t size() const { return static_cast<int64_t>(left_.size()); }

 private:
  void WorkerLoop() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] {
          return stop_ || (next_to_schedule_ < static_cast<int64_t>(left_.size()) &&
                           next_to_schedule_ - next_to_emit_ < capacity_);
        });
        if (stop_) return;
        idx = next_to_schedule_++;
      }
      FramePair fp;
      fp.index = idx;
      fp.left = decode_png_gray(left_[idx].c_str());
      fp.right = decode_png_gray(right_[idx].c_str());
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(fp);
      }
      cv_emit_.notify_all();
    }
  }

  std::vector<std::string> left_, right_;
  const int64_t capacity_;
  int64_t next_to_schedule_;
  int64_t next_to_emit_;
  bool stop_;
  std::vector<FramePair> done_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_emit_;
};

}  // namespace

extern "C" {

// Create a prefetcher over two newline-separated path lists.
void* loader_create(const char* left_paths, const char* right_paths,
                    int n_workers, int ring_capacity) {
  auto split = [](const char* s) {
    std::vector<std::string> out;
    std::string cur;
    for (const char* p = s; *p; ++p) {
      if (*p == '\n') {
        if (!cur.empty()) out.push_back(cur);
        cur.clear();
      } else {
        cur.push_back(*p);
      }
    }
    if (!cur.empty()) out.push_back(cur);
    return out;
  };
  auto l = split(left_paths);
  auto r = split(right_paths);
  if (l.size() != r.size() || l.empty()) return nullptr;
  return new Prefetcher(std::move(l), std::move(r), n_workers, ring_capacity);
}

int loader_next(void* handle, float* out_l, float* out_r, int w, int h) {
  return static_cast<Prefetcher*>(handle)->Next(out_l, out_r, w, h);
}

long long loader_size(void* handle) {
  return static_cast<Prefetcher*>(handle)->size();
}

void loader_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

// One-shot synchronous decode (utility / testing).
int decode_png(const char* path, float* out, int w, int h) {
  Image img = decode_png_gray(path);
  if (!img.ok) return -2;
  if (img.width != w || img.height != h) return -3;
  std::memcpy(out, img.pixels.data(), sizeof(float) * w * h);
  return 0;
}

int png_dims(const char* path, int* w, int* h) {
  Image img = decode_png_gray(path);
  if (!img.ok) return -2;
  *w = img.width;
  *h = img.height;
  return 0;
}

}  // extern "C"
