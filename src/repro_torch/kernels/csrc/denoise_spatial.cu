// Hopper kernel for the post-average 3x3 spatial stage.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   spatial_filter_3x3  <- src/repro/kernels/denoise_spatial.py spatial_filter_3x3 (_spatial_kernel)
//
// (P, H, W) float32 frames -> (P, H, W), image edges replicated. Two modes:
//   box:       the 3x3 mean, as the reference's jitted sum(neighbours) / 9:
//              a sequential sum over the neighbours (rows top to bottom,
//              columns left to right within a row) times f32(1/9);
//   bilateral: uniform support with Gaussian range weights
//              w_i = exp(-(x_i - x_c)^2 * f32(1 / (2 sigma^2))),
//              out = (sum w_i x_i) / (sum w_i), a true division.
//
// Bound: HBM bytes (read each frame once, write it once) for box. Bilateral
// adds nine expf and about eight more operations per neighbour; at 67
// TFLOP/s that is still below the byte time, but only by a small factor.
//
// Design (the simple one): one thread per output pixel, threads along W,
// reading its nine neighbours through the L1 cache (each input pixel is read
// by nine threads, from cache). A shared-memory tile with a one-pixel halo,
// the counterpart of the TPU kernel's clamped neighbour tiles, is a later
// optimisation.
//
// Rounding: box is bitwise equal to the reference (every step an _rn
// intrinsic). Bilateral uses CUDA's expf, which is not XLA's exp: its output
// is held to the plain version within a declared tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool BOX>
__global__ void spatial_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int height, int width,
                               float inv2s2) {
  const int64_t r = blockIdx.x;  // (frame, row)
  const int64_t f = r / height;
  const int h = static_cast<int>(r - f * height);
  const float* frame = in + f * height * static_cast<int64_t>(width);
  const int rows[3] = {h > 0 ? h - 1 : 0, h, h + 1 < height ? h + 1 : height - 1};
  for (int w = threadIdx.x; w < width; w += blockDim.x) {
    const int cols[3] = {w > 0 ? w - 1 : 0, w, w + 1 < width ? w + 1 : width - 1};
    const float xc = frame[static_cast<int64_t>(h) * width + w];
    float acc = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* line = frame + static_cast<int64_t>(rows[i]) * width;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float nb = line[cols[j]];
        if constexpr (BOX) {
          acc = __fadd_rn(acc, nb);
        } else {
          const float d = __fsub_rn(nb, xc);
          const float wgt = expf(__fmul_rn(-__fmul_rn(d, d), inv2s2));
          acc = __fmaf_rn(wgt, nb, acc);
          wsum = __fadd_rn(wsum, wgt);
        }
      }
    }
    out[r * width + w] = BOX ? __fmul_rn(acc, 1.0f / 9.0f) : __fdiv_rn(acc, wsum);
  }
}

}  // namespace

extern "C" {

// `in` and `out` are (frames, H, W) float32; mode 0 = box, 1 = bilateral.
int spatial_filter_3x3_launch(const void* in, void* out, int64_t frames,
                              int64_t height, int64_t width, int mode,
                              float inv2s2, void* stream) {
  const int64_t rows = frames * height;
  if (rows == 0 || width == 0) return cudaSuccess;
  if (rows > 0x7fffffff || width > 0x7fffffff || height > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = width >= 256 ? 256 : static_cast<int>((width + 31) / 32 * 32);
  const int h = static_cast<int>(height), w = static_cast<int>(width);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  if (mode == 0) {
    spatial_kernel<true><<<static_cast<unsigned>(rows), t, 0, s>>>(src, dst, h, w, inv2s2);
  } else if (mode == 1) {
    spatial_kernel<false><<<static_cast<unsigned>(rows), t, 0, s>>>(src, dst, h, w, inv2s2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
