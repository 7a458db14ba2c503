// Native host-side batch assembly ops for the input pipeline.
//
// The torch DataLoader the reference relies on does its decode/resize/
// normalize work in C (libjpeg / torchvision C++ kernels) across worker
// processes; this is the equivalent fast path for the input pipeline:
// multi-threaded bilinear resize + normalize + layout conversion from
// uint8 HWC images into a ready-to-ship float32 NHWC batch, without the
// numpy temporaries.
//
// A copy of sihl_tpu/data/native/batch_ops.cpp for the PyTorch port, built
// by sihl_tpu_torch/data/native.py at first use:
//   g++ -O3 -march=native -shared -fPIC -o libbatch_ops.so batch_ops.cpp -lpthread
// and called through ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear-resize one uint8 HWC image into a float32 slot, applying
// (x/255 - mean) / std per channel.
void resize_normalize_one(const uint8_t* src, int sh, int sw, int c,
                          float* dst, int dh, int dw,
                          const float* mean, const float* stddev) {
  const float y_scale = static_cast<float>(sh) / dh;
  const float x_scale = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * y_scale - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float fy = sy - y0;
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * x_scale - 0.5f;
      sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(sx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float fx = sx - x0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      float* out = dst + (y * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * fx;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * fx;
        const float v = (top + (bot - top) * fy) * (1.0f / 255.0f);
        out[ch] = (v - mean[ch]) / stddev[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// images: array of pointers to uint8 HWC buffers with per-image shapes.
// out: preallocated float32 (batch, dh, dw, c) buffer.
void batch_resize_normalize(const uint8_t** images, const int* heights,
                            const int* widths, int batch, int c,
                            float* out, int dh, int dw,
                            const float* mean, const float* stddev,
                            int num_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= batch) break;
      resize_normalize_one(images[i], heights[i], widths[i], c,
                           out + static_cast<int64_t>(i) * dh * dw * c, dh, dw,
                           mean, stddev);
    }
  };
  if (num_threads <= 1 || batch == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  const int n = std::min(num_threads, batch);
  threads.reserve(n);
  for (int t = 0; t < n; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Pad ragged int32 label rows into a -1-padded (batch, max_targets) grid.
void pad_labels(const int32_t** rows, const int* lengths, int batch,
                int max_targets, int32_t* out) {
  for (int b = 0; b < batch; ++b) {
    int32_t* dst = out + static_cast<int64_t>(b) * max_targets;
    const int n = std::min(lengths[b], max_targets);
    std::memcpy(dst, rows[b], n * sizeof(int32_t));
    std::fill(dst + n, dst + max_targets, -1);
  }
}

}  // extern "C"
