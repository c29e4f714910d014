// Native host-side video ingest for the PyTorch port (tapnet_tpu_torch).
//
// A threaded prefetch pipeline: worker threads parse .npy video files
// (uint8 [T, H, W, 3], C-order), bilinearly resize each frame to the train
// resolution (half-pixel centers, plain bilinear, no antialiasing),
// normalize to float32 in [-1, 1], and enqueue finished batches into a
// bounded ring. The consumer thread (Python, via ctypes) copies batches out
// without holding the GIL during the wait.
//
// The reference framework does this work in a host-side TensorFlow input
// pipeline (tapnet/training/experiment.py:263, utils/experiment_utils.py:
// 183-250); here it is a small dependency-free C++ library so the host CPUs
// keep the accelerator fed without Python-thread contention.
//
// C ABI only — consumed through ctypes (no pybind11 in the image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

struct NpyArray {
  std::vector<int64_t> shape;
  std::string dtype;       // e.g. "|u1", "<f4"
  std::vector<uint8_t> data;
};

// Minimal .npy (format v1/v2) reader for C-order arrays.
bool ReadNpy(const std::string& path, NpyArray* out, std::string* err) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  char magic[6];
  f.read(magic, 6);
  if (f.gcount() != 6 || std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    *err = "not an npy file: " + path;
    return false;
  }
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t header_len = 0;
  if (ver[0] == 1) {
    uint16_t len16;
    f.read(reinterpret_cast<char*>(&len16), 2);
    header_len = len16;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  std::string header(header_len, '\0');
  f.read(header.data(), header_len);

  auto find_value = [&](const std::string& key) -> std::string {
    auto pos = header.find("'" + key + "'");
    if (pos == std::string::npos) return "";
    pos = header.find(':', pos);
    if (pos == std::string::npos) return "";
    ++pos;
    while (pos < header.size() && header[pos] == ' ') ++pos;
    size_t end = pos;
    if (header[pos] == '\'') {
      end = header.find('\'', pos + 1) + 1;
    } else if (header[pos] == '(') {
      end = header.find(')', pos) + 1;
    } else {
      end = header.find_first_of(",}", pos);
    }
    return header.substr(pos, end - pos);
  };

  std::string descr = find_value("descr");
  if (descr.size() >= 2) descr = descr.substr(1, descr.size() - 2);
  out->dtype = descr;

  if (find_value("fortran_order").find("True") != std::string::npos) {
    *err = "fortran-order npy not supported: " + path;
    return false;
  }

  std::string shape_str = find_value("shape");
  out->shape.clear();
  int64_t cur = -1;
  for (char c : shape_str) {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      out->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) out->shape.push_back(cur);

  int64_t elems = 1;
  for (int64_t s : out->shape) elems *= s;
  int64_t itemsize = 1;
  if (!descr.empty()) {
    // descr like "|u1", "<f4", "<i8"
    itemsize = std::stoll(descr.substr(2));
  }
  out->data.resize(static_cast<size_t>(elems * itemsize));
  f.read(reinterpret_cast<char*>(out->data.data()), elems * itemsize);
  if (f.gcount() != elems * itemsize) {
    *err = "truncated npy: " + path;
    return false;
  }
  return true;
}

// Bilinear resize of one uint8 HxWx3 frame into float32 [-1, 1] at
// (out_h, out_w). Half-pixel centers, edge clamp — matches
// a plain bilinear resize (no antialiasing).
void ResizeNormalizeFrame(const uint8_t* src, int64_t h, int64_t w,
                          float* dst, int64_t oh, int64_t ow) {
  const float sy = static_cast<float>(h) / static_cast<float>(oh);
  const float sx = static_cast<float>(w) / static_cast<float>(ow);
  for (int64_t oy = 0; oy < oh; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > h - 1) fy = static_cast<float>(h - 1);
    int64_t y0 = static_cast<int64_t>(fy);
    int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int64_t ox = 0; ox < ow; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > w - 1) fx = static_cast<float>(w - 1);
      int64_t x0 = static_cast<int64_t>(fx);
      int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * w + x0) * 3;
      const uint8_t* p01 = src + (y0 * w + x1) * 3;
      const uint8_t* p10 = src + (y1 * w + x0) * 3;
      const uint8_t* p11 = src + (y1 * w + x1) * 3;
      float* o = dst + (oy * ow + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        o[c] = v / 127.5f - 1.0f;
      }
    }
  }
}

struct Batch {
  std::vector<float> data;  // [B, T, H, W, 3]
};

class Loader {
 public:
  Loader(std::vector<std::string> files, int64_t batch, int64_t frames,
         int64_t out_h, int64_t out_w, int64_t num_threads,
         int64_t queue_cap, uint64_t seed, bool shuffle)
      : files_(std::move(files)),
        batch_(batch),
        frames_(frames),
        out_h_(out_h),
        out_w_(out_w),
        queue_cap_(queue_cap > 0 ? queue_cap : 2),
        shuffle_(shuffle),
        rng_(seed),
        next_file_(0),
        stop_(false) {
    if (shuffle_) Shuffle();
    int64_t n = num_threads > 0 ? num_threads : 2;
    for (int64_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_producer_.notify_all();
    cv_consumer_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Copies the next [B, T, H, W, 3] batch into out. Returns 0 on success.
  int Next(float* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_consumer_.wait(lk, [this] { return !queue_.empty() || !error_.empty(); });
    if (!error_.empty()) {
      g_error = error_;
      return 1;
    }
    Batch b = std::move(queue_.front());
    queue_.pop();
    lk.unlock();
    cv_producer_.notify_one();
    std::memcpy(out, b.data.data(), b.data.size() * sizeof(float));
    return 0;
  }

  int64_t BatchFloats() const {
    return batch_ * frames_ * out_h_ * out_w_ * 3;
  }

 private:
  void Shuffle() {
    for (size_t i = files_.size(); i > 1; --i) {
      std::swap(files_[i - 1], files_[rng_() % i]);
    }
  }

  std::string NextFile() {
    std::lock_guard<std::mutex> lk(file_mu_);
    if (next_file_ >= files_.size()) {
      next_file_ = 0;
      if (shuffle_) Shuffle();
    }
    return files_[next_file_++];
  }

  void WorkerLoop() {
    const int64_t frame_floats = out_h_ * out_w_ * 3;
    while (true) {
      Batch b;
      b.data.resize(BatchFloats());
      for (int64_t e = 0; e < batch_; ++e) {
        std::string path = NextFile();
        NpyArray arr;
        std::string err;
        if (!ReadNpy(path, &arr, &err) || arr.shape.size() != 4 ||
            arr.shape[3] != 3 || arr.dtype != "|u1") {
          std::lock_guard<std::mutex> lk(mu_);
          error_ = err.empty()
                       ? ("bad video npy (want uint8 [T,H,W,3]): " + path)
                       : err;
          cv_consumer_.notify_all();
          return;
        }
        int64_t t_in = arr.shape[0], h = arr.shape[1], w = arr.shape[2];
        float* dst = b.data.data() + e * frames_ * frame_floats;
        for (int64_t t = 0; t < frames_; ++t) {
          // Clamp-repeat the last frame for short clips.
          int64_t ts = t < t_in ? t : t_in - 1;
          ResizeNormalizeFrame(arr.data.data() + ts * h * w * 3, h, w,
                               dst + t * frame_floats, out_h_, out_w_);
        }
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_producer_.wait(lk, [this] {
        return stop_ || queue_.size() < static_cast<size_t>(queue_cap_);
      });
      if (stop_) return;
      queue_.push(std::move(b));
      lk.unlock();
      cv_consumer_.notify_one();
    }
  }

  std::vector<std::string> files_;
  const int64_t batch_, frames_, out_h_, out_w_, queue_cap_;
  const bool shuffle_;
  std::mt19937_64 rng_;

  std::mutex file_mu_;
  size_t next_file_;

  std::mutex mu_;
  std::condition_variable cv_producer_, cv_consumer_;
  std::queue<Batch> queue_;
  std::string error_;
  bool stop_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* tnl_create(const char** paths, int64_t num_paths, int64_t batch,
                 int64_t frames, int64_t out_h, int64_t out_w,
                 int64_t num_threads, int64_t queue_cap, uint64_t seed,
                 int shuffle) {
  if (num_paths <= 0) {
    g_error = "empty file list";
    return nullptr;
  }
  std::vector<std::string> files(paths, paths + num_paths);
  return new Loader(std::move(files), batch, frames, out_h, out_w,
                    num_threads, queue_cap, seed, shuffle != 0);
}

int tnl_next(void* loader, float* out) {
  return static_cast<Loader*>(loader)->Next(out);
}

int64_t tnl_batch_floats(void* loader) {
  return static_cast<Loader*>(loader)->BatchFloats();
}

void tnl_destroy(void* loader) { delete static_cast<Loader*>(loader); }

const char* tnl_last_error() { return g_error.c_str(); }

}  // extern "C"
