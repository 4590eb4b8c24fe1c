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
// Bound: box by HBM bytes (read each frame once, write it once: 81.92 MB,
// 24.45 us at the paper's shape on an H100 SXM). Bilateral by instruction
// issue: an accurate expf is some ten instructions and __fdiv_rn about as
// many, so the weights, not the bytes, set its floor.
//
// Design: one block of 256 threads per (frame, tile of kTileH = 16 rows x
// kTileW = 128 columns), a grid of (column tiles, row tiles, frames): 2 x 5
// tiles of an 80 x 256 frame, 5,000 blocks at P = 500.
//   1. Stage the tile and its one-pixel halo, (16 + 2) x (128 + 2) floats, in
//      shared memory, every thread's loads issued before any store. Image
//      edges are replicated here, by clamping the source row and column, so
//      nothing after this phase knows about edges. Where W % 4 == 0 and both
//      planes are 16-byte aligned (VEC, the host's choice) a thread loads a
//      float4 of four columns; otherwise four scalars.
//   2. Bilateral only: the weight of an edge between two pixels depends only
//      on their values: d = q - p and p - q = -d round alike, so both ends
//      square the same d. So each weight is computed once, as one of four
//      forward weights of the staged cell it leaves (right, down, down-left,
//      down-right; 4.2 expf a pixel, against 9), into shared memory. A pixel
//      reads its other four from its neighbours' forward weights, and its
//      centre weight is expf(-0) = 1 exactly. Every weight, and so every
//      output bit, is the per-pixel kernel's.
//   3. Each thread takes 4 adjacent pixels of 2 rows (lane -> 4 columns, warp
//      -> 2 rows), reads its 3 x 6 neighbourhood of a row as two scalars and a
//      float4, sums in the sequential order above and stores the 4 results as
//      one float4 (VEC) or four scalars.
// Shared memory: 9.8 KB a block for box, 46.8 KB for bilateral (four 17 x 136
// weight planes), so 4 bilateral blocks a SM, held to 64 registers a thread.
//
// Frames of a half type take spatial_half_kernel, one thread a pixel
// (below). Rounding: box is bitwise equal to the reference (every step an _rn
// intrinsic). Bilateral uses CUDA's expf, which is not XLA's exp: a float32
// output is held to the plain version within a declared tolerance; the same
// weights, fma order and __fdiv_rn keep it bitwise equal to the per-pixel
// kernel it replaced. A half type rounds each weight to that type, and its
// output is held bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

using repro_quant::Acc;
using repro_quant::acc_add;
using repro_quant::acc_div;
using repro_quant::acc_mul;
using repro_quant::acc_scale;
using repro_quant::acc_sub;

constexpr int kThreads = 256;
constexpr int kTileW = 128;  // 32 lanes x 4 columns
constexpr int kTileH = 16;   // 8 warps x 2 rows
// A staged row: 3 floats of padding, the left halo, kTileW cells, the right
// halo, padding: cell j (0 = left halo) sits at j + 3, so cells 1..kTileW
// start 16-byte aligned.
constexpr int kStride = kTileW + 8;
constexpr int kValRows = kTileH + 2;  // tile rows -1 .. kTileH
constexpr int kWgtRows = kTileH + 1;  // forward weights of staged rows 0 .. kTileH
constexpr int kVals = kValRows * kStride;
constexpr int kWgts = kWgtRows * kStride;
constexpr int kChunks = kTileW / 4;  // float4s of a staged row's interior

__device__ __forceinline__ int clampi(int x, int hi) { return x < 0 ? 0 : (x > hi ? hi : x); }

// The range weight of the edge between values p and q (either order).
__device__ __forceinline__ float weight(float p, float q, float inv2s2) {
  const float d = __fsub_rn(q, p);
  return expf(__fmul_rn(-__fmul_rn(d, d), inv2s2));
}

// Cells 4l .. 4l+5 of a staged row, given the address of cell 4l + 1.
__device__ __forceinline__ void row6(const float* p, float v[6]) {
  const float4 m = *reinterpret_cast<const float4*>(p);
  v[0] = p[-1];
  v[1] = m.x;
  v[2] = m.y;
  v[3] = m.z;
  v[4] = m.w;
  v[5] = p[4];
}

template <bool BOX, bool VEC>
__global__ void __launch_bounds__(kThreads, BOX ? 1 : 4)
    spatial_tile_kernel(const float* __restrict__ in, float* __restrict__ out, int height,
                        int width, float inv2s2) {
  __shared__ __align__(16) float smem[kVals + (BOX ? 0 : 4 * kWgts)];
  float* vals = smem;
  // grid (column tile, row tile, frame): no division to find the tile, and
  // the tiles of one frame run side by side, sharing their halo rows in L2
  const int64_t plane = static_cast<int64_t>(height) * width;
  const float* frame = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;

  // 1. the tile and its halo, edges replicated (every load before any store).
  // Thread t stages chunk q = t % 32 (4 columns) of rows t / 32 + 8u.
  constexpr int kRowsPerPass = kThreads / kChunks;
  constexpr int kPasses = (kValRows + kRowsPerPass - 1) / kRowsPerPass;
  const int q = threadIdx.x % kChunks, i0 = threadIdx.x / kChunks;
  const int c = w0 + 4 * q, last = width - 1;
  // VEC (W % 4 == 0): the float4 lies wholly inside the row or wholly past its end
  const bool inside = c < width;
  const int c1 = c + 1 < last ? c + 1 : last, c2 = c + 2 < last ? c + 2 : last;
  const int c3 = c + 3 < last ? c + 3 : last, c0 = c < last ? c : last;
  float4 v[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int i = i0 + u * kRowsPerPass;
    if (i < kValRows) {
      const float* src = frame + static_cast<int64_t>(clampi(h0 + i - 1, height - 1)) * width;
      if constexpr (VEC) {
        if (inside) {
          v[u] = *reinterpret_cast<const float4*>(src + c);
        } else {
          const float e = src[last];
          v[u] = make_float4(e, e, e, e);
        }
      } else {
        v[u] = make_float4(src[c0], src[c1], src[c2], src[c3]);
      }
    }
  }
  float halo = 0.0f;
  if (threadIdx.x < 2 * kValRows) {
    const int i = threadIdx.x >> 1;
    const float* src = frame + static_cast<int64_t>(clampi(h0 + i - 1, height - 1)) * width;
    halo = src[threadIdx.x & 1 ? (w0 + kTileW < width ? w0 + kTileW : last) : (w0 > 0 ? w0 - 1 : 0)];
  }
  float* stage = vals + i0 * kStride + 4 + 4 * q;
#pragma unroll
  for (int u = 0; u < kPasses; ++u)
    if (i0 + u * kRowsPerPass < kValRows)
      *reinterpret_cast<float4*>(stage + u * kRowsPerPass * kStride) = v[u];
  if (threadIdx.x < 2 * kValRows)
    vals[(threadIdx.x >> 1) * kStride + (threadIdx.x & 1 ? kTileW + 4 : 3)] = halo;
  __syncthreads();

  // 2. bilateral: every edge weight once, as a forward weight of its first cell
  float* w_r = smem + kVals;    // (i, j) -> (i, j+1)
  float* w_d = w_r + kWgts;     // (i, j) -> (i+1, j)
  float* w_dl = w_d + kWgts;    // (i, j) -> (i+1, j-1)
  float* w_dr = w_dl + kWgts;   // (i, j) -> (i+1, j+1)
  if constexpr (!BOX) {
    constexpr int kEdges = 3 * kTileH;  // the halo columns' weights the pixels read
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kWgtRows * kChunks + kEdges; idx += kThreads) {
      if (idx < kWgtRows * kChunks) {  // cells 4q+1 .. 4q+4 of staged row i
        const int i = idx / kChunks, o = i * kStride + 4 + 4 * (idx % kChunks);
        float a[6], c[6];
        row6(vals + o, a);
        row6(vals + o + kStride, c);
        float4 r, d, dl, dr;
        r = make_float4(weight(a[1], a[2], inv2s2), weight(a[2], a[3], inv2s2),
                        weight(a[3], a[4], inv2s2), weight(a[4], a[5], inv2s2));
        d = make_float4(weight(a[1], c[1], inv2s2), weight(a[2], c[2], inv2s2),
                        weight(a[3], c[3], inv2s2), weight(a[4], c[4], inv2s2));
        dl = make_float4(weight(a[1], c[0], inv2s2), weight(a[2], c[1], inv2s2),
                         weight(a[3], c[2], inv2s2), weight(a[4], c[3], inv2s2));
        dr = make_float4(weight(a[1], c[2], inv2s2), weight(a[2], c[3], inv2s2),
                         weight(a[3], c[4], inv2s2), weight(a[4], c[5], inv2s2));
        if (i > 0) *reinterpret_cast<float4*>(w_r + o) = r;  // row 0's right weights go unread
        *reinterpret_cast<float4*>(w_d + o) = d;
        *reinterpret_cast<float4*>(w_dl + o) = dl;
        *reinterpret_cast<float4*>(w_dr + o) = dr;
      } else {  // halo cells: right of the left halo (rows 1..16), down-right of
                // it (rows 0..15), down-left of the right halo (rows 0..15)
        const int e = idx - kWgtRows * kChunks, kind = e / kTileH, i = e % kTileH + (kind == 0);
        const float* row = vals + i * kStride;
        if (kind == 0) w_r[i * kStride + 3] = weight(row[3], row[4], inv2s2);
        if (kind == 1) w_dr[i * kStride + 3] = weight(row[3], row[kStride + 4], inv2s2);
        if (kind == 2)
          w_dl[i * kStride + kTileW + 4] = weight(row[kTileW + 4], row[kStride + kTileW + 3], inv2s2);
      }
    }
    __syncthreads();
  }

  // 3. 4 pixels of 2 rows a thread, summed in the sequential order
  const int lane = threadIdx.x & 31, col = w0 + 4 * lane;
  if (col >= width) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * (threadIdx.x >> 5) + 1 + rr;  // staged row of the output row
    const int row = h0 + r - 1;
    if (row >= height) break;
    const int o = r * kStride + 4 + 4 * lane;  // cell 4 * lane + 1 of staged row r
    float x[3][6];
#pragma unroll
    for (int m = 0; m < 3; ++m) row6(vals + o + (m - 1) * kStride, x[m]);
    float res[4];
    if constexpr (BOX) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) acc = __fadd_rn(acc, x[m][k + dc]);
        res[k] = __fmul_rn(acc, 1.0f / 9.0f);
      }
    } else {
      float ul[6], u[6], ur[6], lr[6], dl[6], d[6], dr[6];
      row6(w_dr + o - kStride, ul);
      row6(w_d + o - kStride, u);
      row6(w_dl + o - kStride, ur);
      row6(w_r + o, lr);
      row6(w_dl + o, dl);
      row6(w_d + o, d);
      row6(w_dr + o, dr);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // the nine weights in the neighbours' order; index k + 1 is this pixel's cell
        const float wk[3][3] = {{ul[k], u[k + 1], ur[k + 2]},
                                {lr[k], 1.0f, lr[k + 1]},
                                {dl[k + 1], d[k + 1], dr[k + 1]}};
        float acc = 0.0f, wsum = 0.0f;
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            acc = __fmaf_rn(wk[m][dc], x[m][k + dc], acc);
            wsum = __fadd_rn(wsum, wk[m][dc]);
          }
        res[k] = __fdiv_rn(acc, wsum);
      }
    }
    float* line = dst + static_cast<int64_t>(row) * width + col;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(line) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col + k < width) line[k] = res[k];
    }
  }
}

// Frames of a half type A (__half or __nv_bfloat16; quant.cuh Acc): one
// thread per output pixel over a (column, row, frame) grid of 32 x 8 blocks,
// the nine neighbours read from global memory with the edges clamped, every
// operation rounded to A as the reference's kernel body rounds it: box sums
// in the neighbours' order and scales by the host's f16(1/9) (float16) or
// divides by 9 (bfloat16); bilateral rounds each weight's difference,
// square, scaled argument and expf, accumulates w * x as one float16 FMA
// (float16, the first two products as fma(w0, x0, f16(w1 * x1))) or a
// rounded product and add (bfloat16), and divides truly.
template <bool BOX, typename A>
__global__ void spatial_half_kernel(const A* __restrict__ in, A* __restrict__ out, int height,
                                    int width, float inv2s2, float rcp9) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || row >= height) return;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const A* frame = in + blockIdx.z * plane;
  const float c = Acc<A>::load(frame[static_cast<int64_t>(row) * width + col]);
  float acc = 0.0f, wsum = 0.0f, w0 = 0.0f, x0 = 0.0f;
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const A* line = frame + static_cast<int64_t>(clampi(row + dr, height - 1)) * width;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const float x = Acc<A>::load(line[clampi(col + dc, width - 1)]);
      if constexpr (BOX) {
        acc = acc_add<A>(acc, x);
      } else {
        const float d = acc_sub<A>(x, c);
        const float w =
            Acc<A>::round(expf(acc_mul<A>(-acc_mul<A>(d, d), inv2s2)));
        if constexpr (Acc<A>::kContracts) {
          // as XLA: the zero start folded away and w0*x0 + w1*x1
          // contracted on its first product
          const int k = (dr + 1) * 3 + dc + 1;  // a constant once unrolled
          if (k == 0) {
            w0 = w;
            x0 = x;
          } else {
            acc = k == 1 ? Acc<A>::fma(w0, x0, acc_mul<A>(w, x)) : Acc<A>::fma(w, x, acc);
          }
        } else {
          acc = acc_add<A>(acc, acc_mul<A>(w, x));
        }
        wsum = acc_add<A>(wsum, w);
      }
    }
  }
  out[blockIdx.z * plane + static_cast<int64_t>(row) * width + col] =
      Acc<A>::store(BOX ? acc_scale<A>(acc, rcp9, 9.0f) : acc_div<A>(acc, wsum));
}

template <bool BOX, typename A>
cudaError_t launch_half(const void* in, void* out, int64_t frames, int h, int w, float inv2s2,
                        float rcp9, cudaStream_t s) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const dim3 block(32, 8);
  if ((h + 7) / 8 > 65535) return cudaErrorInvalidValue;
  const A* src = static_cast<const A*>(in);
  A* dst = static_cast<A*>(out);
  for (int64_t f0 = 0; f0 < frames; f0 += 65535) {
    const dim3 grid((w + 31) / 32, (h + 7) / 8,
                    static_cast<unsigned>(frames - f0 < 65535 ? frames - f0 : 65535));
    spatial_half_kernel<BOX, A><<<grid, block, 0, s>>>(src + f0 * plane, dst + f0 * plane, h, w,
                                                       inv2s2, rcp9);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One launch per 65,535 frames (the grid's z limit).
template <bool BOX>
cudaError_t launch(const float* in, float* out, int64_t frames, int h, int w, bool vec,
                   float inv2s2, cudaStream_t s) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int64_t f0 = 0; f0 < frames; f0 += 65535) {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    static_cast<unsigned>(frames - f0 < 65535 ? frames - f0 : 65535));
    if (vec) {
      spatial_tile_kernel<BOX, true><<<grid, kThreads, 0, s>>>(in + f0 * plane, out + f0 * plane,
                                                               h, w, inv2s2);
    } else {
      spatial_tile_kernel<BOX, false><<<grid, kThreads, 0, s>>>(in + f0 * plane, out + f0 * plane,
                                                                h, w, inv2s2);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// `in` and `out` are (frames, H, W) of the type `acc` (AccumCode: float32,
// float16 or bfloat16); mode 0 = box, 1 = bilateral. `inv2s2` and `rcp9`
// (box's 1/9, read for float16 only) come rounded to that type. `vector`
// asks for the float32 kernel's float4 path; a launch whose planes do not
// allow it (W % 4 != 0, either pointer not 16-byte aligned, or a half type)
// returns cudaErrorMisalignedAddress.
int spatial_filter_3x3_launch(const void* in, void* out, int64_t frames,
                              int64_t height, int64_t width, int mode, int vector,
                              float inv2s2, float rcp9, int acc, void* stream) {
  if (frames == 0 || height == 0 || width == 0) return cudaSuccess;
  if (width > 0x7fffffff - kTileW || (height + kTileH - 1) / kTileH > 65535)
    return cudaErrorInvalidValue;
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
  if (vector && (width % 4 || reinterpret_cast<uintptr_t>(in) % 16 ||
                 reinterpret_cast<uintptr_t>(out) % 16 || acc != repro_quant::kAccF32))
    return cudaErrorMisalignedAddress;
  if (acc == repro_quant::kAccF16 || acc == repro_quant::kAccBF16) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int h = static_cast<int>(height), w = static_cast<int>(width);
    if (acc == repro_quant::kAccF16) {
      return mode == 0 ? launch_half<true, __half>(in, out, frames, h, w, inv2s2, rcp9, s)
                       : launch_half<false, __half>(in, out, frames, h, w, inv2s2, rcp9, s);
    }
    return mode == 0 ? launch_half<true, __nv_bfloat16>(in, out, frames, h, w, inv2s2, rcp9, s)
                     : launch_half<false, __nv_bfloat16>(in, out, frames, h, w, inv2s2, rcp9, s);
  }
  if (acc != repro_quant::kAccF32) return cudaErrorInvalidValue;
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), w = static_cast<int>(width);
  if (mode == 0) return launch<true>(src, dst, frames, h, w, vector != 0, inv2s2, s);
  if (mode == 1) return launch<false>(src, dst, frames, h, w, vector != 0, inv2s2, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
