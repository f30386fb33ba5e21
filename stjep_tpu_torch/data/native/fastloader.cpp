// Native batch loader for fbank .npy files: the host I/O hot spot of the
// training loop (the reference does per-utterance np.load + CMVN + pad in
// Python inside the data loader, ref: utils/dataset.py:157-184).
//
// Exposed via a C ABI for ctypes:
//   stjep_load_batch(paths, n, mus, stds, acous_dim, out, T, D)
// - parses NPY v1/v2 headers (float32/float64, C-order, [len, D])
// - applies per-speaker CMVN 1.0*(x-mu)/std when mu/std given
// - zero-pads rows to T frames into the caller's [n, T, D] float32 buffer
// - parallelised over utterances with a std::thread pool.
//
// Built by stjep_tpu_torch/data/loader.py at first use (g++ -O3 -shared
// -fPIC -pthread) into stjep_tpu_torch/build/.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Minimal NPY parser. Returns 0 on success.
int read_npy_f32(const char* path, std::vector<float>& data, long& rows,
                 long& cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return 2;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (std::fread(hl, 1, 2, f) != 2) { std::fclose(f); return 3; }
    header_len = hl[0] | (hl[1] << 8);
  } else {
    unsigned char hl[4];
    if (std::fread(hl, 1, 4, f) != 4) { std::fclose(f); return 3; }
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) | (hl[3] << 24);
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    std::fclose(f);
    return 4;
  }
  bool f64 = header.find("<f8") != std::string::npos;
  bool f32 = header.find("<f4") != std::string::npos;
  if (!f32 && !f64) { std::fclose(f); return 5; }
  if (header.find("'fortran_order': True") != std::string::npos) {
    std::fclose(f);
    return 6;
  }
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) { std::fclose(f); return 7; }
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) {
    std::fclose(f);
    return 7;
  }
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  rows = std::atol(shape.c_str());
  size_t comma = shape.find(',');
  cols = (comma == std::string::npos) ? 1 : std::atol(shape.c_str() + comma + 1);
  if (rows <= 0 || cols <= 0) { std::fclose(f); return 8; }

  size_t count = (size_t)rows * (size_t)cols;
  data.resize(count);
  if (f64) {
    std::vector<double> tmp(count);
    if (std::fread(tmp.data(), 8, count, f) != count) {
      std::fclose(f);
      return 9;
    }
    for (size_t i = 0; i < count; ++i) data[i] = (float)tmp[i];
  } else {
    if (std::fread(data.data(), 4, count, f) != count) {
      std::fclose(f);
      return 9;
    }
  }
  std::fclose(f);
  return 0;
}

}  // namespace

extern "C" {

// paths: n C strings; mus/stds: per-utterance pointers to [stat_dim] f32 or
// nullptr; out: [n, T, D] float32 zero-filled by callee; lens_out: [n].
// Returns 0 on success, else (index*100 + errcode) of the first failure.
int stjep_load_batch(const char** paths, long n, const float** mus,
                     const float** stds, long stat_dim, float* out, long T,
                     long D, long* lens_out) {
  std::atomic<long> next(0);
  std::atomic<int> err(0);
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = hw ? (hw < (unsigned)n ? hw : (unsigned)n) : 1;

  auto work = [&]() {
    std::vector<float> buf;
    long rows, cols;
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      int rc = read_npy_f32(paths[i], buf, rows, cols);
      if (rc) {
        int expect = 0;
        err.compare_exchange_strong(expect, (int)(i * 100 + rc));
        break;
      }
      if (cols != D || rows > T) {
        int expect = 0;
        err.compare_exchange_strong(expect, (int)(i * 100 + 50));
        break;
      }
      lens_out[i] = rows;
      float* dst = out + (size_t)i * T * D;
      std::memset(dst, 0, (size_t)T * D * sizeof(float));
      const float* mu = mus ? mus[i] : nullptr;
      const float* sd = stds ? stds[i] : nullptr;
      if (mu && sd) {
        // drop a trailing training-energy term if stats are wider
        // (ref: utils/dataset.py:169-172)
        for (long r = 0; r < rows; ++r) {
          const float* srcp = buf.data() + (size_t)r * D;
          float* dstp = dst + (size_t)r * D;
          for (long c = 0; c < D; ++c) {
            dstp[c] = (srcp[c] - mu[c]) / sd[c];
          }
        }
      } else {
        std::memcpy(dst, buf.data(), (size_t)rows * D * sizeof(float));
      }
    }
  };

  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n_threads; ++t) threads.emplace_back(work);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

}  // extern "C"
