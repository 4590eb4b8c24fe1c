// Hopper kernel for the EMA + running-variance streaming filter.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   ema_welford_step  <- src/repro/kernels/denoise_ema.py ema_welford_step (_ema_kernel)
// and fuses the shared dequantization prologue (B1, quant.cuh).
//
// One group step does two things per pixel (h, w):
//   * ema[p, h, w] = fma(ema, 1 - a, a * diff) for every pair p, in place;
//   * the per-pixel mean and M2, pooled over every diff sample seen, take
//     the group's N/2 samples pair_tile at a time, each chunk merged by
//     Chan's parallel update, in chunk order.
//
// Bound: HBM bytes (read the wire group, read + write the ema frames, read +
// write two (H, W) planes), about 16 floating-point operations per pair.
//
// Design (the simple one, which matches the reference's order of rounding):
// one thread per pixel (h, w) walks the P / pair_tile chunks in order, as the
// TPU grid walks its sequential pair axis with the mean/M2 tiles resident in
// VMEM; here they stay in registers and are written once at the end. Within
// a chunk the thread reads its pairs once to update the EMA and sum the
// chunk, then again (an L1/L2 hit) for the chunk's centred sum of squares.
// With H * W = 20,480 threads at the paper's shape, each with a 100-step
// sequential loop, the card is far from full: a later PR can split the EMA
// update (parallel over pairs) from the merge.
//
// Rounding is part of the contract. The reference's interpret-mode kernel is
// compiled by XLA, which contracts some products into FMAs and keeps others;
// each operation below is written with an _rn intrinsic in that order:
//   ema'   = fma(ema, 1 - a, a * d)
//   s      = ((0 + d_0) + d_1) + ... ,   cm = s * f32(1/m)
//   chunk  = fma(d_m-1 - cm, d_m-1 - cm, ... fma(d_0 - cm, d_0 - cm, 0))
//   n      = prior + k * m,  tot = n + m,  r = m / tot,  c = (n * m) / tot
//   mean'  = fma(fma(s, 1/m, -mean), r, mean)
//   M2'    = M2 + fma((cm - mean)^2, c, chunk)
// with m = pair_tile and k the chunk's index. The host passes 1 - a, a and
// 1/m already rounded to float32.

#include "quant.cuh"

namespace {

using namespace repro_quant;

// Grid: one thread per (h, item); for p12 an item is two pixels. The wire
// frame of pair p is 2p (control) and 2p + 1 (excitation).
template <int FMT>
__global__ void ema_kernel(const uint8_t* __restrict__ frames,
                           float* __restrict__ ema, float* __restrict__ mean,
                           float* __restrict__ m2, int pairs, int height,
                           int items, int64_t row_bytes, int pair_tile,
                           float offset, float u8_scale, float alpha,
                           float one_minus_alpha, float prior,
                           float rcp_tile) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(height) * items) return;
  const int64_t h = t / items;
  const int x = static_cast<int>(t - h * items);
  const int64_t width = static_cast<int64_t>(items) * P;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t frame_bytes = static_cast<int64_t>(height) * row_bytes;
  const uint8_t* row = frames + h * row_bytes;
  float* ema_px = ema + h * width + static_cast<int64_t>(x) * P;
  float* mean_px = mean + h * width + static_cast<int64_t>(x) * P;
  float* m2_px = m2 + h * width + static_cast<int64_t>(x) * P;

  float mu[P], var[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    mu[k] = mean_px[k];
    var[k] = m2_px[k];
  }
  const float m = static_cast<float>(pair_tile);
  const int chunks = pairs / pair_tile;
  for (int c = 0; c < chunks; ++c) {
    const int p0 = c * pair_tile;
    float s[P];
#pragma unroll
    for (int k = 0; k < P; ++k) s[k] = 0.0f;
    for (int i = 0; i < pair_tile; ++i) {
      const int64_t p = p0 + i;
      const uint8_t* ctl = row + (2 * p) * frame_bytes;
      float d[P];
      pair_diff<FMT>(ctl, ctl + frame_bytes, x, offset, u8_scale, d);
      float* e = ema_px + p * plane;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        e[k] = __fmaf_rn(e[k], one_minus_alpha, __fmul_rn(alpha, d[k]));
        s[k] = __fadd_rn(s[k], d[k]);
      }
    }
    float cm[P], chunk[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      cm[k] = __fmul_rn(s[k], rcp_tile);
      chunk[k] = 0.0f;
    }
    for (int i = 0; i < pair_tile; ++i) {
      const uint8_t* ctl = row + (2 * static_cast<int64_t>(p0 + i)) * frame_bytes;
      float d[P];
      pair_diff<FMT>(ctl, ctl + frame_bytes, x, offset, u8_scale, d);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dc = __fsub_rn(d[k], cm[k]);
        chunk[k] = __fmaf_rn(dc, dc, chunk[k]);
      }
    }
    const float n = __fadd_rn(prior, __fmul_rn(static_cast<float>(c), m));
    const float tot = __fadd_rn(n, m);
    const float r = __fdiv_rn(m, tot);
    const float w = __fdiv_rn(__fmul_rn(n, m), tot);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dp = __fsub_rn(cm[k], mu[k]);
      var[k] = __fadd_rn(var[k], __fmaf_rn(__fmul_rn(dp, dp), w, chunk[k]));
      mu[k] = __fmaf_rn(__fmaf_rn(s[k], rcp_tile, -mu[k]), r, mu[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    mean_px[k] = mu[k];
    m2_px[k] = var[k];
  }
}

template <int FMT>
cudaError_t launch(const void* frames, void* ema, void* mean, void* m2,
                   int pairs, int height, int items, int64_t row_bytes,
                   int pair_tile, float offset, float u8_scale, float alpha,
                   float one_minus_alpha, float prior, float rcp_tile,
                   cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int64_t threads = static_cast<int64_t>(height) * items;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  ema_kernel<FMT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(frames), static_cast<float*>(ema),
      static_cast<float*>(mean), static_cast<float*>(m2), pairs, height, items,
      row_bytes, pair_tile, offset, u8_scale, alpha, one_minus_alpha, prior,
      rcp_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `frames` is one group (N, H, wire_W); `ema` (N/2, H, W); `mean` and `m2`
// (H, W), all float32 and updated in place. `items` is W, or W/2 for p12;
// `pair_tile` divides `pairs`; `prior` is the sample count already merged.
int ema_welford_step_launch(const void* frames, void* ema, void* mean,
                            void* m2, int64_t pairs, int64_t height,
                            int64_t items, int64_t row_bytes,
                            int64_t pair_tile, int fmt, float offset,
                            float u8_scale, float alpha, float one_minus_alpha,
                            float prior, float rcp_tile, void* stream) {
  if (pairs == 0 || height == 0 || items == 0) return cudaSuccess;
  if (pair_tile < 1 || pairs % pair_tile || pairs > 0x3fffffff ||
      height * items > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(pairs), h = static_cast<int>(height);
  const int it = static_cast<int>(items), tp = static_cast<int>(pair_tile);
#define EMA(F) launch<F>(frames, ema, mean, m2, p, h, it, row_bytes, tp, offset, u8_scale, alpha, one_minus_alpha, prior, rcp_tile, s)
  switch (fmt) {
    case kU16: return EMA(kU16);
    case kU8: return EMA(kU8);
    case kP12: return EMA(kP12);
  }
#undef EMA
  return cudaErrorInvalidValue;
}

}  // extern "C"
