// Hopper kernel for the post-average 3x3 spatial stage.
//
// Replaces one Pallas TPU kernel of the JAX package:
//   spatial_filter_3x3  <- src/repro/kernels/denoise_spatial.py spatial_filter_3x3 (_spatial_kernel)
//
// (P, H, W) float32, float16 or bfloat16 frames -> (P, H, W) of their
// type, image edges replicated. Two modes:
//   box:       the 3x3 mean, as the reference's jitted sum(neighbours) / 9:
//              a sequential sum over the neighbours (rows top to bottom,
//              columns left to right within a row) times f32(1/9);
//   bilateral: uniform support with Gaussian range weights
//              w_i = exp(-(x_i - x_c)^2 * f32(1 / (2 sigma^2))),
//              out = (sum w_i x_i) / (sum w_i), a true division.
//
// Bound: box by HBM bytes (read each frame once, write it once: 81.92 MB,
// 24.45 us at the paper's shape on an H100 SXM; half that in a half type).
// Bilateral by instruction issue: an accurate expf is some ten instructions
// and __fdiv_rn about as many, so the weights, not the bytes, set its floor.
//
// Design: one block of 256 threads per (frame, tile of kTileH = 16 rows x
// kTileW = 128 columns), a grid of (column tiles, row tiles, frames): 2 x 5
// tiles of an 80 x 256 frame, 5,000 blocks at P = 500.
//   1. Stage the tile and its one-pixel halo, (16 + 2) x (128 + 2) floats, in
//      shared memory, every thread's loads issued before any store. Image
//      edges are replicated here, by clamping the source row and column, so
//      nothing after this phase knows about edges. Where W % 4 == 0 and both
//      planes are aligned to four pixels (VEC, the host's choice: 16 bytes
//      for float32, 8 for a half type) a thread loads four columns at once;
//      otherwise four scalars. A half value is staged as the float it equals.
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
//      float4, sums in the sequential order above and stores the 4 results
//      with one store (VEC) or four scalars.
// Shared memory: 9.8 KB a block for box, 46.8 KB for bilateral (four 17 x 136
// weight planes), so 4 bilateral blocks a SM, held to 64 registers a thread.
//
// Rounding: every operation is rounded to the frames' type A (quant.cuh Acc)
// as the reference's kernel body rounds it. Box sums in order in A and scales
// by the host's 1/9 (float32, float16) or divides by 9 (bfloat16). A weight
// is A(expf(A(-A(d * d) * inv2s2))) with d = A(q - p); the weighted sum takes
// the neighbours in order as fma(w, x, acc) (float32; float16 as one float16
// FMA, its first two products as fma(w0, x0, f16(w1 * x1)), as XLA contracts
// them) or a rounded product and add (bfloat16); the weights sum in A and the
// division is true. Box is bitwise equal to the reference. Bilateral uses
// CUDA's expf, which is not XLA's exp: a float32 output is held to the plain
// version within a declared tolerance, and the same weights, fma order and
// __fdiv_rn keep it bitwise equal to the per-pixel kernel it replaced. A half
// type rounds each weight to that type, and its output is held bitwise.

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

// The range weight of the edge between values p and q (either order), in A.
template <typename A>
__device__ __forceinline__ float weight(float p, float q, float inv2s2) {
  const float d = acc_sub<A>(q, p);
  return Acc<A>::round(expf(acc_mul<A>(-acc_mul<A>(d, d), inv2s2)));
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

// A half value from its 16 bits, and back.
template <typename A>
__device__ __forceinline__ float from_bits(uint32_t b) {
  const auto bits = static_cast<unsigned short>(b);
  if constexpr (std::is_same_v<A, __half>) {
    return Acc<A>::load(__ushort_as_half(bits));
  } else {
    return Acc<A>::load(__ushort_as_bfloat16(bits));
  }
}
template <typename A>
__device__ __forceinline__ uint32_t to_bits(float x) {
  if constexpr (std::is_same_v<A, __half>) {
    return __half_as_ushort(Acc<A>::store(x));
  } else {
    return __bfloat16_as_ushort(Acc<A>::store(x));
  }
}

// Four consecutive values of A at p, aligned to four of them: one 16-byte
// load for float32, one 8-byte load for a half type.
template <typename A>
__device__ __forceinline__ float4 load4(const A* p) {
  if constexpr (std::is_same_v<A, float>) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(from_bits<A>(u.x & 0xFFFFu), from_bits<A>(u.x >> 16),
                       from_bits<A>(u.y & 0xFFFFu), from_bits<A>(u.y >> 16));
  }
}

// Store four results to p, aligned to four values of A, as one store.
template <typename A>
__device__ __forceinline__ void store4(A* p, const float (&r)[4]) {
  if constexpr (std::is_same_v<A, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(to_bits<A>(r[0]) | (to_bits<A>(r[1]) << 16),
                                              to_bits<A>(r[2]) | (to_bits<A>(r[3]) << 16));
  }
}

template <bool BOX, bool VEC, typename A>
__global__ void __launch_bounds__(kThreads, BOX ? 1 : 4)
    spatial_tile_kernel(const A* __restrict__ in, A* __restrict__ out, int height, int width,
                        float inv2s2, float rcp9) {
  __shared__ __align__(16) float smem[kVals + (BOX ? 0 : 4 * kWgts)];
  float* vals = smem;
  // grid (column tile, row tile, frame): no division to find the tile, and
  // the tiles of one frame run side by side, sharing their halo rows in L2
  const int64_t plane = static_cast<int64_t>(height) * width;
  const A* frame = in + blockIdx.z * plane;
  A* dst = out + blockIdx.z * plane;
  const int h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;

  // 1. the tile and its halo, edges replicated (every load before any store).
  // Thread t stages chunk q = t % 32 (4 columns) of rows t / 32 + 8u.
  constexpr int kRowsPerPass = kThreads / kChunks;
  constexpr int kPasses = (kValRows + kRowsPerPass - 1) / kRowsPerPass;
  const int q = threadIdx.x % kChunks, i0 = threadIdx.x / kChunks;
  const int c = w0 + 4 * q, last = width - 1;
  // VEC (W % 4 == 0): the four columns lie wholly inside the row or wholly past its end
  const bool inside = c < width;
  const int c1 = c + 1 < last ? c + 1 : last, c2 = c + 2 < last ? c + 2 : last;
  const int c3 = c + 3 < last ? c + 3 : last, c0 = c < last ? c : last;
  float4 v[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int i = i0 + u * kRowsPerPass;
    if (i < kValRows) {
      const A* src = frame + static_cast<int64_t>(clampi(h0 + i - 1, height - 1)) * width;
      if constexpr (VEC) {
        if (inside) {
          v[u] = load4(src + c);
        } else {
          const float e = Acc<A>::load(src[last]);
          v[u] = make_float4(e, e, e, e);
        }
      } else {
        v[u] = make_float4(Acc<A>::load(src[c0]), Acc<A>::load(src[c1]), Acc<A>::load(src[c2]),
                           Acc<A>::load(src[c3]));
      }
    }
  }
  float halo = 0.0f;
  if (threadIdx.x < 2 * kValRows) {
    const int i = threadIdx.x >> 1;
    const A* src = frame + static_cast<int64_t>(clampi(h0 + i - 1, height - 1)) * width;
    halo = Acc<A>::load(
        src[threadIdx.x & 1 ? (w0 + kTileW < width ? w0 + kTileW : last) : (w0 > 0 ? w0 - 1 : 0)]);
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
    auto wt = [inv2s2](float p, float q) { return weight<A>(p, q, inv2s2); };
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kWgtRows * kChunks + kEdges; idx += kThreads) {
      if (idx < kWgtRows * kChunks) {  // cells 4q+1 .. 4q+4 of staged row i
        const int i = idx / kChunks, o = i * kStride + 4 + 4 * (idx % kChunks);
        float a[6], c[6];
        row6(vals + o, a);
        row6(vals + o + kStride, c);
        float4 r, d, dl, dr;
        r = make_float4(wt(a[1], a[2]), wt(a[2], a[3]), wt(a[3], a[4]), wt(a[4], a[5]));
        d = make_float4(wt(a[1], c[1]), wt(a[2], c[2]), wt(a[3], c[3]), wt(a[4], c[4]));
        dl = make_float4(wt(a[1], c[0]), wt(a[2], c[1]), wt(a[3], c[2]), wt(a[4], c[3]));
        dr = make_float4(wt(a[1], c[2]), wt(a[2], c[3]), wt(a[3], c[4]), wt(a[4], c[5]));
        if (i > 0) *reinterpret_cast<float4*>(w_r + o) = r;  // row 0's right weights go unread
        *reinterpret_cast<float4*>(w_d + o) = d;
        *reinterpret_cast<float4*>(w_dl + o) = dl;
        *reinterpret_cast<float4*>(w_dr + o) = dr;
      } else {  // halo cells: right of the left halo (rows 1..16), down-right of
                // it (rows 0..15), down-left of the right halo (rows 0..15)
        const int e = idx - kWgtRows * kChunks, kind = e / kTileH, i = e % kTileH + (kind == 0);
        const float* row = vals + i * kStride;
        if (kind == 0) w_r[i * kStride + 3] = wt(row[3], row[4]);
        if (kind == 1) w_dr[i * kStride + 3] = wt(row[3], row[kStride + 4]);
        if (kind == 2) w_dl[i * kStride + kTileW + 4] = wt(row[kTileW + 4], row[kStride + kTileW + 3]);
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
          for (int dc = 0; dc < 3; ++dc) acc = acc_add<A>(acc, x[m][k + dc]);
        res[k] = acc_scale<A>(acc, rcp9, 9.0f);
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
            const float w = wk[m][dc], xv = x[m][k + dc];
            if constexpr (std::is_same_v<A, __half>) {
              // as XLA: the zero start folded away, w0*x0 + w1*x1 contracted
              // on its first product
              if (m == 0 && dc == 1) acc = Acc<A>::fma(wk[0][0], x[0][k], acc_mul<A>(w, xv));
              if (m > 0 || dc > 1) acc = Acc<A>::fma(w, xv, acc);
            } else if constexpr (Acc<A>::kContracts) {
              acc = __fmaf_rn(w, xv, acc);
            } else {
              acc = acc_add<A>(acc, acc_mul<A>(w, xv));
            }
            wsum = acc_add<A>(wsum, w);
          }
        res[k] = acc_div<A>(acc, wsum);
      }
    }
    A* line = dst + static_cast<int64_t>(row) * width + col;
    if constexpr (VEC) {
      store4(line, res);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (col + k < width) line[k] = Acc<A>::store(res[k]);
    }
  }
}

// One launch per 65,535 frames (the grid's z limit).
template <bool BOX, typename A>
cudaError_t launch(const void* in, void* out, int64_t frames, int h, int w, bool vec,
                   float inv2s2, float rcp9, cudaStream_t s) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const A* src = static_cast<const A*>(in);
  A* dst = static_cast<A*>(out);
  for (int64_t f0 = 0; f0 < frames; f0 += 65535) {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    static_cast<unsigned>(frames - f0 < 65535 ? frames - f0 : 65535));
    if (vec) {
      spatial_tile_kernel<BOX, true, A><<<grid, kThreads, 0, s>>>(src + f0 * plane,
                                                                  dst + f0 * plane, h, w, inv2s2,
                                                                  rcp9);
    } else {
      spatial_tile_kernel<BOX, false, A><<<grid, kThreads, 0, s>>>(src + f0 * plane,
                                                                   dst + f0 * plane, h, w, inv2s2,
                                                                   rcp9);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename A>
cudaError_t launch_mode(int mode, const void* in, void* out, int64_t frames, int h, int w,
                        bool vec, float inv2s2, float rcp9, cudaStream_t s) {
  return mode == 0 ? launch<true, A>(in, out, frames, h, w, vec, inv2s2, rcp9, s)
                   : launch<false, A>(in, out, frames, h, w, vec, inv2s2, rcp9, s);
}

}  // namespace

extern "C" {

// `in` and `out` are (frames, H, W) of the type `acc` (AccumCode: float32,
// float16 or bfloat16); mode 0 = box, 1 = bilateral. `inv2s2` and `rcp9`
// (box's 1/9, read for float32 and float16) come rounded to that type.
// `vector` asks for the path of four-pixel loads and stores; a launch whose
// planes do not allow it (W % 4 != 0, or either pointer not aligned to four
// pixels: 16 bytes for float32, 8 for a half type) returns
// cudaErrorMisalignedAddress.
int spatial_filter_3x3_launch(const void* in, void* out, int64_t frames,
                              int64_t height, int64_t width, int mode, int vector,
                              float inv2s2, float rcp9, int acc, void* stream) {
  if (frames == 0 || height == 0 || width == 0) return cudaSuccess;
  if (width > 0x7fffffff - kTileW || (height + kTileH - 1) / kTileH > 65535)
    return cudaErrorInvalidValue;
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
  const uintptr_t align = acc == repro_quant::kAccF32 ? 16 : 8;
  if (vector && (width % 4 || reinterpret_cast<uintptr_t>(in) % align ||
                 reinterpret_cast<uintptr_t>(out) % align))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), w = static_cast<int>(width);
  const bool vec = vector != 0;
  switch (acc) {
    case repro_quant::kAccF32: return launch_mode<float>(mode, in, out, frames, h, w, vec, inv2s2, rcp9, s);
    case repro_quant::kAccF16: return launch_mode<__half>(mode, in, out, frames, h, w, vec, inv2s2, rcp9, s);
    case repro_quant::kAccBF16:
      return launch_mode<__nv_bfloat16>(mode, in, out, frames, h, w, vec, inv2s2, rcp9, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
