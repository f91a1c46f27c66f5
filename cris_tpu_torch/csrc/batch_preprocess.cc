// The batched data plane: one call preprocesses a whole train or val batch
// on a pool of C++ threads, so Python releases its interpreter lock once a
// batch (ctypes releases it around the call). Each job:
//   decode (image_codec.cc: BGR, EXIF orientation) -> RGB -> the letterbox
//   affine -> the separable cubic warp with the CLIP-mean border -> rint,
//   clamp, uint8 -> (x / 255 - mean) / std into NHWC float32,
// and for train masks: decode (gray) -> the separable linear warp with a
// zero border -> / 255 -> float32.
//
// Every value equals the per-sample numpy path's bit for bit
// (cris_tpu_torch/data/transforms.py: get_transform_mats, _invert_affine,
// _axis_taps, _warp, warp_image, warp_mask, normalize_image): source
// coordinates in float32 (a multiply, then an add), weights and sums in
// float64 in numpy's order, the normalisation in float32. So this file is
// compiled with -ffp-contract=off (no fused multiply-add) and without
// -ffast-math.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "image_codec.h"

namespace {

constexpr double kA = -0.75;  // OpenCV's Keys cubic
// transforms.py's CLIP_MEAN and CLIP_STD: float32 values of the doubles
const float kMean[3] = {(float)0.48145466, (float)0.4578275, (float)0.40821073};
const float kStd[3] = {(float)0.26862954, (float)0.26130258, (float)0.27577711};

// get_transform_mats: forward (original -> letterboxed) and inverse 2 x 3
// affines, row-major.
void transform_mats(int ori_h, int ori_w, int inp, double mat[6],
                    double inv[6]) {
  const double scale = std::min((double)inp / ori_h, (double)inp / ori_w);
  const double new_h = ori_h * scale, new_w = ori_w * scale;
  const double bias_x = (inp - new_w) / 2.0, bias_y = (inp - new_h) / 2.0;
  const double m[6] = {scale, 0.0, bias_x, 0.0, scale, bias_y};
  const double v[6] = {1.0 / scale, 0.0, -bias_x / scale,
                       0.0, 1.0 / scale, -bias_y / scale};
  std::memcpy(mat, m, sizeof m);
  std::memcpy(inv, v, sizeof v);
}

// _invert_affine, in OpenCV's order of operations.
void invert_affine(const double m[6], double out[6]) {
  double det = m[0] * m[4] - m[1] * m[3];
  det = det != 0 ? 1.0 / det : 0.0;
  const double a11 = m[4] * det, a22 = m[0] * det;
  const double a12 = -m[1] * det, a21 = -m[3] * det;
  const double b1 = -a11 * m[2] - a12 * m[5];
  const double b2 = -a21 * m[2] - a22 * m[5];
  const double v[6] = {a11, a12, b1, a21, a22, b2};
  std::memcpy(out, v, sizeof v);
}

// _axis_taps: for src = scale * dst + offset, `taps` source indices per
// output (clipped into the source) and their weights (0 outside it), and
// inside = the sum of the weights in order.
struct Taps {
  int taps;
  std::vector<int> idx;
  std::vector<double> w, inside;

  Taps(int out_size, int in_size, double scale, double offset, bool cubic)
      : taps(cubic ? 4 : 2),
        idx((size_t)out_size * taps),
        w((size_t)out_size * taps),
        inside((size_t)out_size) {
    const float fs = (float)scale, fo = (float)offset;
    for (int i = 0; i < out_size; ++i) {
      float src = (float)i * fs;
      src = src + fo;
      const float base = std::floor(src);
      const double frac = (double)(src - base);
      double wt[4];
      if (cubic) {  // _cubic_weights, taps at -1, 0, 1, 2
        const double x = frac + 1.0;
        wt[0] = ((kA * x - 5 * kA) * x + 8 * kA) * x - 4 * kA;
        wt[1] = ((kA + 2) * frac - (kA + 3)) * frac * frac + 1;
        const double y = 1.0 - frac;
        wt[2] = ((kA + 2) * y - (kA + 3)) * y * y + 1;
        wt[3] = 1.0 - wt[0] - wt[1] - wt[2];
      } else {  // _linear_weights, taps at 0, 1
        wt[0] = 1.0 - frac;
        wt[1] = frac;
      }
      const long long first = (long long)base - (cubic ? 1 : 0);
      double sum = 0.0;
      for (int k = 0; k < taps; ++k) {
        const long long j = first + k;
        const bool in = j >= 0 && j < in_size;
        const double wk = in ? wt[k] : 0.0;
        idx[(size_t)i * taps + k] = (int)(j < 0 ? 0 : j >= in_size ? in_size - 1 : j);
        w[(size_t)i * taps + k] = wk;
        sum = k == 0 ? wk : sum + wk;
      }
      inside[i] = sum;
    }
  }
};

// warp_image + normalize_image: (H, W) BGR uint8 -> (S, S, 3) RGB float32.
void warp_image(const cris::Image& img, const double mat[6], int S,
                const float lut[3][256], float* out) {
  double inv[6];
  invert_affine(mat, inv);
  const Taps ty(S, img.height, inv[4], inv[5], true);
  const Taps tx(S, img.width, inv[0], inv[2], true);
  double border[3];
  for (int c = 0; c < 3; ++c) border[c] = std::nearbyint((double)kMean[c] * 255);
  const int W = img.width;
  const uint8_t* px = img.pixels.data();
  // rows: the vertical pass of output row y over every source column, in
  // the source's BGR order (contiguous, so the compiler vectorises it)
  const size_t row_len = (size_t)W * 3;
  std::vector<double> rows(row_len);
  for (int y = 0; y < S; ++y) {
    const int* iy = &ty.idx[(size_t)y * 4];
    const double* wy = &ty.w[(size_t)y * 4];
    if (wy[0] == 0.0 && wy[1] == 0.0 && wy[2] == 0.0 && wy[3] == 0.0) {
      // every tap outside the image: each sum is +0.0
      std::fill(rows.begin(), rows.end(), 0.0);
    } else {
      const uint8_t* r0 = px + (size_t)iy[0] * row_len;
      const uint8_t* r1 = px + (size_t)iy[1] * row_len;
      const uint8_t* r2 = px + (size_t)iy[2] * row_len;
      const uint8_t* r3 = px + (size_t)iy[3] * row_len;
      double* rw = rows.data();
      for (size_t j = 0; j < row_len; ++j) {
        double acc = 0.0 + wy[0] * (double)r0[j];
        acc = acc + wy[1] * (double)r1[j];
        acc = acc + wy[2] * (double)r2[j];
        rw[j] = acc + wy[3] * (double)r3[j];
      }
    }
    float* o = out + (size_t)y * S * 3;
    for (int x = 0; x < S; ++x) {
      const int* ix = &tx.idx[(size_t)x * 4];
      const double* wx = &tx.w[(size_t)x * 4];
      const double inside = ty.inside[y] * tx.inside[x];
      const double* c0 = &rows[(size_t)ix[0] * 3];
      const double* c1 = &rows[(size_t)ix[1] * 3];
      const double* c2 = &rows[(size_t)ix[2] * 3];
      const double* c3 = &rows[(size_t)ix[3] * 3];
      for (int c = 0; c < 3; ++c) {  // RGB channel c is BGR channel 2 - c
        const int b = 2 - c;
        double acc = 0.0 + wx[0] * c0[b];
        acc = acc + wx[1] * c1[b];
        acc = acc + wx[2] * c2[b];
        acc = acc + wx[3] * c3[b];
        double v = std::nearbyint(acc + border[c] * (1.0 - inside));
        v = v < 0 ? 0 : v > 255 ? 255 : v;
        o[3 * x + c] = lut[c][(int)v];
      }
    }
  }
}

// warp_mask: (H, W) uint8 -> (S, S) float32 in [0, 1].
void warp_mask(const cris::Image& mask, const double mat[6], int S,
               float* out) {
  double inv[6];
  invert_affine(mat, inv);
  const Taps ty(S, mask.height, inv[4], inv[5], false);
  const Taps tx(S, mask.width, inv[0], inv[2], false);
  const int W = mask.width;
  const uint8_t* px = mask.pixels.data();
  std::vector<double> rows((size_t)W);
  for (int y = 0; y < S; ++y) {
    const int* iy = &ty.idx[(size_t)y * 2];
    const double* wy = &ty.w[(size_t)y * 2];
    const uint8_t* r0 = px + (size_t)iy[0] * W;
    const uint8_t* r1 = px + (size_t)iy[1] * W;
    for (int x = 0; x < W; ++x) {
      rows[x] = (0.0 + wy[0] * (double)r0[x]) + wy[1] * (double)r1[x];
    }
    float* o = out + (size_t)y * S;
    for (int x = 0; x < S; ++x) {
      const int* ix = &tx.idx[(size_t)x * 2];
      const double* wx = &tx.w[(size_t)x * 2];
      const double acc = (0.0 + wx[0] * rows[ix[0]]) + wx[1] * rows[ix[1]];
      const double inside = ty.inside[y] * tx.inside[x];
      o[x] = (float)((acc + 0.0 * (1.0 - inside)) / 255.0);
    }
  }
}

struct Job {
  const uint8_t* img;
  size_t img_len;
  const uint8_t* mask;  // null: no mask
  size_t mask_len;
  float* img_out;
  float* mask_out;
  double* inv_out;   // may be null
  int32_t* ori_out;  // may be null
};

void process(const Job& job, int S, const float lut[3][256]) {
  const cris::Image img = cris::decode(job.img, job.img_len, false);
  double mat[6], inv[6];
  transform_mats(img.height, img.width, S, mat, inv);
  if (job.inv_out) std::memcpy(job.inv_out, inv, sizeof inv);
  if (job.ori_out) {
    job.ori_out[0] = img.height;
    job.ori_out[1] = img.width;
  }
  warp_image(img, mat, S, lut, job.img_out);
  if (job.mask) {
    const cris::Image mask = cris::decode(job.mask, job.mask_len, true);
    warp_mask(mask, mat, S, job.mask_out);
  }
}

}  // namespace

extern "C" {

// Preprocess n samples: image bytes (JPEG or PNG) into img_out (n x S x S x
// 3 float32, NHWC RGB normalised), mask bytes (nullable) into mask_out (n x
// S x S float32), the inverse affines into inv_out (n x 2 x 3 float64,
// nullable) and the decoded (height, width) into ori_out (n x 2 int32,
// nullable), on min(nthreads, n) threads. Returns 0, or 1 with
// "sample <i>: <message>" in err for the lowest failing index.
int cris_batch_preprocess(const uint8_t* const* img_ptrs, const size_t* img_lens,
                          const uint8_t* const* mask_ptrs,
                          const size_t* mask_lens, int n, int input_size,
                          int nthreads, float* img_out, float* mask_out,
                          double* inv_out, int32_t* ori_out, char* err,
                          int errlen) {
  const int S = input_size;
  if (n < 0 || S < 1 || (mask_ptrs && (!mask_lens || !mask_out))) {
    if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "bad arguments");
    return 1;
  }
  // normalize_image's float32 operations, one table per channel
  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    for (int p = 0; p < 256; ++p) lut[c][p] = ((float)p / 255.0f - kMean[c]) / kStd[c];
  }
  const size_t img_stride = (size_t)S * S * 3, mask_stride = (size_t)S * S;
  std::vector<Job> jobs((size_t)n);
  for (int i = 0; i < n; ++i) {
    Job& j = jobs[(size_t)i];
    j.img = img_ptrs[i];
    j.img_len = img_lens[i];
    j.mask = mask_ptrs ? mask_ptrs[i] : nullptr;
    j.mask_len = mask_ptrs ? mask_lens[i] : 0;
    j.img_out = img_out + i * img_stride;
    j.mask_out = mask_out ? mask_out + i * mask_stride : nullptr;
    j.inv_out = inv_out ? inv_out + 6 * (size_t)i : nullptr;
    j.ori_out = ori_out ? ori_out + 2 * (size_t)i : nullptr;
  }
  std::vector<std::string> errors((size_t)n);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) {
      try {
        process(jobs[(size_t)i], S, lut);
      } catch (const cris::Fault& f) {
        errors[(size_t)i] = f.what();
      } catch (const std::bad_alloc&) {
        errors[(size_t)i] = "out of memory";
      }
    }
  };
  const int threads = std::max(1, std::min(nthreads, n));
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve((size_t)threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  for (int i = 0; i < n; ++i) {
    if (!errors[(size_t)i].empty()) {
      if (err && errlen > 0) {
        std::snprintf(err, (size_t)errlen, "sample %d: %s", i,
                      errors[(size_t)i].c_str());
      }
      return 1;
    }
  }
  return 0;
}

// The interface version that data/native.py binds.
int cris_data_abi_version() { return 1; }

}  // extern "C"
