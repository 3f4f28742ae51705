// Native batch encoder: raw cached scenes -> packed diffusion targets.
//
// Copy of diffuscene_tpu/native/batcher.cpp, the C++ equivalent of the
// host-side encoding pipeline (data/encoding.py, itself a re-design of the
// reference decorator stack
// scene_synthesis/datasets/threed_front_dataset.py:228-1072).
// One call fuses, per scene: fixed-90-degree rotation augmentation ->
// min/max scaling to [-1,1] -> cos/sin angle encoding -> objfeats
// normalization -> random object permutation -> padding to max_length with
// the "end" one-hot -> class-label {-1,+1} mapping -> packing
// [trans | size | angle | class | objfeat] into one contiguous
// (batch, max_length, point_dim) float32 tensor ready for device transfer.
//
// The reference runs this as a chain of per-sample Python Dataset wrappers
// inside torch DataLoader workers; here it is a single multithreaded pass
// with a deterministic splitmix64 RNG per (seed, scene) pair.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97f4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

inline float scale_to_unit(float x, float lo, float hi) {
  x = std::min(std::max(x, lo), hi);
  float t = (x - lo) / (hi - lo);
  return 2.0f * t - 1.0f;
}

struct Bounds {
  float t_lo[3], t_hi[3];
  float s_lo[3], s_hi[3];
  float a_lo, a_hi;
  float f_lo, f_hi;
};

}  // namespace

extern "C" {

// Encode one batch of raw scenes into packed diffusion targets.
//
// Inputs are (batch, max_in, ...) row-major float32 with per-scene valid
// counts in `lengths`.  `bounds` is 16 floats:
//   [t_min(3), t_max(3), s_min(3), s_max(3), a_min, a_max, f_min, f_max].
// Output `out` is (batch, max_length, point_dim) with
// point_dim = 3 + 3 + 2 + n_classes_out + objfeat_dim and
// n_classes_out = n_classes_in - 1 (the "start" channel is dropped, "end"
// kept as the trailing empty indicator — threed_front_dataset.py:888-925).
//
// Flags: do_permute applies a random object permutation; rotation_mode
// 0 = none, 1 = fixed 90-degree steps, 2 = continuous (uniform in
// [0.174533, 5.06145) with prob 0.5 — threed_front_dataset.py:330-346).
void encode_diffusion_batch(
    const float* translations, const float* sizes, const float* angles,
    const float* class_labels, const float* objfeats, const int* lengths,
    int batch, int max_in, int n_classes_in, int objfeat_dim,
    const float* bounds_raw, int max_length, uint64_t seed, int do_permute,
    int rotation_mode, float* out, int n_threads) {
  const int n_classes_out = n_classes_in - 1;
  const int point_dim = 3 + 3 + 2 + n_classes_out + objfeat_dim;
  Bounds b;
  std::memcpy(b.t_lo, bounds_raw + 0, 3 * sizeof(float));
  std::memcpy(b.t_hi, bounds_raw + 3, 3 * sizeof(float));
  std::memcpy(b.s_lo, bounds_raw + 6, 3 * sizeof(float));
  std::memcpy(b.s_hi, bounds_raw + 9, 3 * sizeof(float));
  b.a_lo = bounds_raw[12];
  b.a_hi = bounds_raw[13];
  b.f_lo = bounds_raw[14];
  b.f_hi = bounds_raw[15];

  auto encode_scene = [&](int s) {
    SplitMix64 rng(seed * 0x9E3779B97f4A7C15ULL + (uint64_t)s + 1);
    const int n = std::min(lengths[s], max_length);

    // rotation augmentation angle
    double rot = 0.0;
    if (rotation_mode == 1) {
      // cascade-equivalent thresholds for the reference fixed_rot_angle
      // re-draw quirk (threed_front_dataset.py:338-346):
      // P = {1.5pi: 0.25, pi: 0.375, 0.5pi: 0.28125, 0: 0.09375}
      double u = rng.uniform();
      rot = (u < 0.25) ? 4.71238898038469 : (u < 0.625) ? 3.141592653589793
            : (u < 0.90625) ? 1.5707963267948966 : 0.0;
    } else if (rotation_mode == 2) {
      if (rng.uniform() < 0.5) rot = 0.174533 + rng.uniform() * (5.06145 - 0.174533);
    }
    const double cr = std::cos(rot), sr = std::sin(rot);

    // permutation of the valid slots
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    if (do_permute) {
      for (int i = n - 1; i > 0; --i) {
        int j = (int)rng.below((uint64_t)i + 1);
        std::swap(order[i], order[j]);
      }
    }

    float* dst_scene = out + (size_t)s * max_length * point_dim;
    for (int slot = 0; slot < max_length; ++slot) {
      float* dst = dst_scene + (size_t)slot * point_dim;
      if (slot < n) {
        const int i = order[slot];
        const float* t = translations + ((size_t)s * max_in + i) * 3;
        const float* sz = sizes + ((size_t)s * max_in + i) * 3;
        const float a_raw = angles[(size_t)s * max_in + i];
        const float* cl = class_labels + ((size_t)s * max_in + i) * n_classes_in;
        // rotate the scene around +y: translations.dot(R) with
        // R = [[c,0,-s],[0,1,0],[s,0,c]] (encoding.py rotation_matrix_around_y)
        const float tx = (float)(t[0] * cr + t[2] * sr);
        const float tz = (float)(-t[0] * sr + t[2] * cr);
        // angle shift wrapped into [a_min, a_min + 2pi)
        double a = std::fmod((double)a_raw + rot - (double)b.a_lo, kTwoPi);
        if (a < 0) a += kTwoPi;
        a += (double)b.a_lo;

        dst[0] = scale_to_unit(tx, b.t_lo[0], b.t_hi[0]);
        dst[1] = scale_to_unit(t[1], b.t_lo[1], b.t_hi[1]);
        dst[2] = scale_to_unit(tz, b.t_lo[2], b.t_hi[2]);
        for (int k = 0; k < 3; ++k)
          dst[3 + k] = scale_to_unit(sz[k], b.s_lo[k], b.s_hi[k]);
        dst[6] = (float)std::cos(a);
        dst[7] = (float)std::sin(a);
        // classes: drop "start" (index n_classes_in-2), keep "end" last,
        // map one-hot {0,1} -> {-1,+1}
        for (int k = 0; k < n_classes_out - 1; ++k)
          dst[8 + k] = cl[k] * 2.0f - 1.0f;
        dst[8 + n_classes_out - 1] = cl[n_classes_in - 1] * 2.0f - 1.0f;
        if (objfeat_dim > 0) {
          const float* f = objfeats + ((size_t)s * max_in + i) * objfeat_dim;
          for (int k = 0; k < objfeat_dim; ++k)
            dst[8 + n_classes_out + k] = scale_to_unit(f[k], b.f_lo, b.f_hi);
        }
      } else {
        // padding: zeros + "end" one-hot mapped to {-1, +1}
        for (int k = 0; k < point_dim; ++k) dst[k] = 0.0f;
        for (int k = 0; k < n_classes_out - 1; ++k) dst[8 + k] = -1.0f;
        dst[8 + n_classes_out - 1] = 1.0f;
      }
    }
  };

  if (n_threads <= 1 || batch == 1) {
    for (int s = 0; s < batch; ++s) encode_scene(s);
    return;
  }
  const int workers = std::min(n_threads, batch);
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&, w]() {
      for (int s = w; s < batch; s += workers) encode_scene(s);
    });
  }
  for (auto& th : pool) th.join();
}

// Version tag so the Python wrapper can detect stale shared objects.
int diffuscene_native_abi_version() { return 1; }

}  // extern "C"
