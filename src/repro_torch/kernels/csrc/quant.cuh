// B1: the shared dequantization prologue of every ingest kernel.
//
// Replaces src/repro/kernels/quant.py pair_diff_block, which the JAX package
// runs inside each Pallas ingest kernel. Here it is a __device__ function
// that the ingest kernels (denoise_stream.cu, denoise_median.cu,
// denoise_ema.cu) inline, so a wire byte is read once, in the kernel that
// uses it. pair_diff reads one thread item (one pixel, or two for p12);
// pair_diff8 and its loaders, below it, read eight pixels with vector loads
// and round exactly as pair_diff does.
//
// Rounding is part of the contract: the reference's jitted prologue computes
// the u8 dequant as fma(e, S, -(c*S)) + offset. It is written here with _rn
// intrinsics, which nvcc never contracts or reorders, so the default
// -fmad=true cannot change a result.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_quant {

enum WireFormat : int { kU16 = 0, kU8 = 1, kP12 = 2 };

// Logical pixels produced per thread item (a p12 item is 3 bytes, 2 pixels).
template <int FMT>
struct Item {
  static constexpr int kPixels = FMT == kP12 ? 2 : 1;
};

// Dequantize one control/excitation pair at item x of a wire row and
// return exc - ctl + offset for each of the item's pixels.
template <int FMT>
__device__ __forceinline__ void pair_diff(const uint8_t* __restrict__ ctl,
                                          const uint8_t* __restrict__ exc,
                                          int x, float offset, float u8_scale,
                                          float d[Item<FMT>::kPixels]) {
  if constexpr (FMT == kU16) {
    const float c = static_cast<float>(reinterpret_cast<const uint16_t*>(ctl)[x]);
    const float e = static_cast<float>(reinterpret_cast<const uint16_t*>(exc)[x]);
    d[0] = __fadd_rn(__fsub_rn(e, c), offset);
  } else if constexpr (FMT == kU8) {
    const float c = static_cast<float>(ctl[x]);
    const float e = static_cast<float>(exc[x]);
    d[0] = __fadd_rn(__fmaf_rn(e, u8_scale, -__fmul_rn(c, u8_scale)), offset);
  } else {
    const uint8_t* cp = ctl + 3 * x;
    const uint8_t* ep = exc + 3 * x;
    const int c0 = cp[0], c1 = cp[1], c2 = cp[2];
    const int e0 = ep[0], e1 = ep[1], e2 = ep[2];
    const float clo = static_cast<float>(c0 | ((c1 & 0xF) << 8));
    const float chi = static_cast<float>((c1 >> 4) | (c2 << 4));
    const float elo = static_cast<float>(e0 | ((e1 & 0xF) << 8));
    const float ehi = static_cast<float>((e1 >> 4) | (e2 << 4));
    d[0] = __fadd_rn(__fsub_rn(elo, clo), offset);
    d[1] = __fadd_rn(__fsub_rn(ehi, chi), offset);
  }
}

// Vector helpers of the step kernels' vector path (denoise_stream.cu): eight
// pixels of one wire plane in one wide load, 16 bytes for u16 and 8 for u8.
// Vector v of a plane starts at byte 8 * v * (pixel bytes), so the plane
// start must be aligned to the load width. p12 (12 bytes a vector, which no
// single load takes) stays on the scalar path.
template <int FMT>
struct Wire8;
template <>
struct Wire8<kU16> { uint4 v; };
template <>
struct Wire8<kU8> { uint2 v; };

template <int FMT>
__device__ __forceinline__ Wire8<FMT> load8(const uint8_t* __restrict__ plane, int64_t v) {
  Wire8<FMT> x;
  x.v = reinterpret_cast<const decltype(x.v)*>(plane)[v];
  return x;
}

// The wire value of pixel k (0..7) of a loaded vector, exactly as a float.
template <int FMT>
__device__ __forceinline__ float pixel8(const Wire8<FMT>& x, int k) {
  if constexpr (FMT == kU16) {
    const uint32_t w = k < 2 ? x.v.x : k < 4 ? x.v.y : k < 6 ? x.v.z : x.v.w;
    return static_cast<float>((k & 1) ? (w >> 16) : (w & 0xFFFFu));
  } else {
    const uint32_t w = k < 4 ? x.v.x : x.v.y;
    return static_cast<float>((w >> (8 * (k & 3))) & 0xFFu);
  }
}

// exc - ctl + offset for the eight pixels of a vector, rounded as pair_diff.
template <int FMT>
__device__ __forceinline__ void pair_diff8(const Wire8<FMT>& ctl, const Wire8<FMT>& exc,
                                           float offset, float u8_scale, float d[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float c = pixel8<FMT>(ctl, k);
    const float e = pixel8<FMT>(exc, k);
    if constexpr (FMT == kU8) {
      d[k] = __fadd_rn(__fmaf_rn(e, u8_scale, -__fmul_rn(c, u8_scale)), offset);
    } else {
      d[k] = __fadd_rn(__fsub_rn(e, c), offset);
    }
  }
}

// Integer sums (int32, or uint16 that wraps at 16 bits), u16 wire only: the
// plain versions' integer arithmetic (repro_torch/kernels/ref.py), which
// computes in int32 and wraps back. The pair difference exc - ctl + offset is
// taken in int32 (offset = trunc(f32 offset), the plain version's int32 cast
// of it for every |offset| < 2^24) and narrowed to the sum type; a sum wraps
// at its width after every add; a division floors, as Python's // does (CUDA's
// integer / truncates toward zero, which differs for a negative int32). Adds
// run in uint32, so an int32 overflow wraps as PyTorch's does, without C++'s
// undefined signed overflow.
template <typename T>
struct IntSum;
template <>
struct IntSum<int32_t> {
  static __device__ __forceinline__ int32_t narrow(uint32_t x) { return static_cast<int32_t>(x); }
  static __device__ __forceinline__ int32_t add(int32_t s, int32_t d) {
    return static_cast<int32_t>(static_cast<uint32_t>(s) + static_cast<uint32_t>(d));
  }
  static __device__ __forceinline__ int32_t div(int32_t x, int32_t g) {  // g > 0
    const int32_t q = x / g;
    return x % g < 0 ? q - 1 : q;
  }
};
template <>
struct IntSum<uint16_t> {
  static __device__ __forceinline__ uint16_t narrow(uint32_t x) { return static_cast<uint16_t>(x); }
  static __device__ __forceinline__ uint16_t add(uint16_t s, uint16_t d) {
    return static_cast<uint16_t>(s + d);
  }
  static __device__ __forceinline__ uint16_t div(uint16_t x, int32_t g) {  // x >= 0: trunc = floor
    return static_cast<uint16_t>(x / g);
  }
};

// exc - ctl + offset of one u16 pixel pair, narrowed to the sum type T.
template <typename T>
__device__ __forceinline__ T int_pair_diff(uint16_t ctl, uint16_t exc, int32_t offset) {
  return IntSum<T>::narrow(uint32_t{exc} - uint32_t{ctl} + static_cast<uint32_t>(offset));
}

// Accumulator codes of the C entry points: float32, int32, uint16.
enum AccumCode : int { kAccF32 = 0, kAccI32 = 1, kAccU16 = 2 };

// Threads per block for a row of `items` thread items: whole warps, <= 256.
inline int threads_for(int items) {
  const int t = ((items + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

// Launch geometry of the row-gridded kernels (the B2/B4 scalar and integer
// steps, B3/B5, B6 and B10): a block covers `rt` consecutive image rows of
// `pt` consecutive pairs, over a 1-D grid of ceil(pairs / pt) x
// ceil(height / rt) blocks. rt = pt = 1, the default, is one block per
// (pair, image row). The geometry changes which block computes an output
// row, never how: every row is computed as in any other geometry.
inline int64_t row_tile_blocks(int64_t pairs, int64_t height, int64_t rt, int64_t pt) {
  return ((pairs + pt - 1) / pt) * ((height + rt - 1) / rt);
}

// Whether a row-tiled launch is valid: 1 <= rt <= height, 1 <= pt <= pairs,
// and at most 2^31 - 1 blocks.
inline bool row_tiles_ok(int64_t pairs, int64_t height, int64_t rt, int64_t pt) {
  return rt >= 1 && pt >= 1 && rt <= height && pt <= pairs &&
         row_tile_blocks(pairs, height, rt, pt) <= 0x7fffffff;
}

// Call f(pair, image row) for each row this block covers, rows innermost (a
// pair's rows are contiguous in memory).
template <typename F>
__device__ __forceinline__ void for_tile_rows(int64_t pairs, int height, int rt, int pt, F&& f) {
  const int64_t row_blocks = (height + rt - 1) / rt;
  const int64_t pb = blockIdx.x / row_blocks;
  const int64_t hb = blockIdx.x - pb * row_blocks;
  const int64_t p_end = (pb + 1) * pt < pairs ? (pb + 1) * pt : pairs;
  const int64_t h_end = (hb + 1) * rt < height ? (hb + 1) * rt : height;
  for (int64_t p = pb * pt; p < p_end; ++p)
    for (int64_t h = hb * rt; h < h_end; ++h) f(p, h);
}

// Run launch(std::true_type{}) for a plan's geometry (tiled), else
// launch(std::false_type{}), so that the launch site names its kernel's form
// as kernel<..., decltype(form)::value>; returns the launch's error.
template <typename F>
inline cudaError_t in_form(bool tiled, F&& launch) {
  if (tiled) {
    launch(std::true_type{});
  } else {
    launch(std::false_type{});
  }
  return cudaGetLastError();
}

}  // namespace repro_quant
