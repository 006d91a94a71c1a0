// Native multithreaded point-cloud batch loader.
//
// Host-side counterpart of the reference's DataLoader worker pool for point
// loading (mmdet3d LoadPointsFromFile + LoadPointsFromMultiSweeps,
// configured at FocalFormer3D_L.py:64-75: 10 sweeps, remove_close, per-sweep
// sensor->lidar transform + time-lag channel). One call loads all files of a
// sample in parallel, applies the rigid transforms and close-point filter
// in-place, and concatenates into a caller-provided fixed-capacity buffer —
// replacing ~11 sequential numpy fromfile+matmul passes per sample.
//
// Built as a shared library and bound with ctypes (see native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FileJob {
  const char* path;
  const float* rot;    // 3x3 row-major, nullptr = identity
  const float* trans;  // 3, nullptr = zero
  float time_lag;
  bool remove_close;
  // outputs
  std::vector<float> data;  // rows * load_dim after filtering
  int64_t rows = 0;
};

void load_one(FileJob* job, int load_dim, float close_radius) {
  FILE* f = std::fopen(job->path, "rb");
  if (!f) return;
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n = bytes / (int64_t)(load_dim * sizeof(float));
  std::vector<float> raw((size_t)n * load_dim);
  const size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
  std::fclose(f);
  const int64_t rows_in = (int64_t)(got / load_dim);

  job->data.resize((size_t)rows_in * load_dim);
  const bool has_rot = job->rot != nullptr;
  const bool has_trans = job->trans != nullptr;
  const float r2 = close_radius;
  int64_t out_rows = 0;
  for (int64_t i = 0; i < rows_in; ++i) {
    const float* p = &raw[(size_t)i * load_dim];
    float x = p[0], y = p[1], z = p[2];
    if (job->remove_close) {
      const float ax = x < 0 ? -x : x;
      const float ay = y < 0 ? -y : y;
      if (ax < r2 && ay < r2) continue;
    }
    float* q = &job->data[(size_t)out_rows * load_dim];
    if (has_rot) {
      const float* R = job->rot;
      q[0] = R[0] * x + R[1] * y + R[2] * z;
      q[1] = R[3] * x + R[4] * y + R[5] * z;
      q[2] = R[6] * x + R[7] * y + R[8] * z;
    } else {
      q[0] = x; q[1] = y; q[2] = z;
    }
    if (has_trans) {
      q[0] += job->trans[0];
      q[1] += job->trans[1];
      q[2] += job->trans[2];
    }
    for (int c = 3; c < load_dim; ++c) q[c] = p[c];
    if (load_dim > 4) q[4] = job->time_lag;
    ++out_rows;
  }
  job->rows = out_rows;
}

}  // namespace

extern "C" {

// Returns total rows written to `out` (<= capacity). `rotations` /
// `translations` may contain identity/zero entries; `use_rot[i]` /
// `use_trans[i]` gate them; `remove_close[i]` gates the close filter.
int64_t ffl_load_sweeps(
    const char** paths, int n_files,
    const float* rotations,     // n_files * 9
    const float* translations,  // n_files * 3
    const float* time_lags,     // n_files
    const uint8_t* use_rot, const uint8_t* use_trans,
    const uint8_t* remove_close,
    int load_dim, float close_radius,
    float* out, int64_t capacity, int n_threads) {
  std::vector<FileJob> jobs(n_files);
  for (int i = 0; i < n_files; ++i) {
    jobs[i].path = paths[i];
    jobs[i].rot = use_rot[i] ? &rotations[9 * i] : nullptr;
    jobs[i].trans = use_trans[i] ? &translations[3 * i] : nullptr;
    jobs[i].time_lag = time_lags[i];
    jobs[i].remove_close = remove_close[i] != 0;
  }

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_files) break;
      load_one(&jobs[i], load_dim, close_radius);
    }
  };
  const int nt = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < nt && t < n_files; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();

  int64_t total = 0;
  for (int i = 0; i < n_files; ++i) {
    const int64_t take =
        jobs[i].rows < capacity - total ? jobs[i].rows : capacity - total;
    if (take <= 0) break;
    std::memcpy(out + (size_t)total * load_dim, jobs[i].data.data(),
                (size_t)take * load_dim * sizeof(float));
    total += take;
  }
  return total;
}

}  // extern "C"
