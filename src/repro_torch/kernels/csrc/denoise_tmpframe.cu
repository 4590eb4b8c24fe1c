// B10: the paper's Algorithm 1 and 2 baselines on Hopper, two passes through HBM.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/denoise_tmpframe.py
// that alg1_subtract_average and alg2_subtract_average run through _two_pass:
//   pass A  tmpframe_subtract  <- _subtract_kernel (the pallas_call at :75)
//   pass B  tmpframe_reduce    <- _reduce_kernel   (the pallas_call at :93)
//
// Bound: HBM bytes. Pass A reads the u16 frames (G*N*H*W*2 bytes) and writes
// every difference frame, the tmpFrame (G*N/2*H*W*4 bytes); pass B reads the
// tmpFrame back and writes the averaged frames. At the paper's shape (G = 8,
// N = 1000, 80 x 256) that is 655.36 + 368.64 = 1024 MB, 305.7 us at
// 3.35 TB/s, where the fused Algorithm 3 kernel (denoise_stream.cu) moves
// 368.64 MB. The design keeps the paper's two-pass dataflow on purpose: the
// tmpFrame really goes to HBM and comes back, because that traffic is what
// the paper measures against Algorithm 3 (its Tables 1-2). Fusing the passes
// would turn this into Algorithm 3 and measure nothing.
//
// Access granularity is the paper's AXI burst flag, as on the TPU:
//   * Alg 1, pass A: one block per (group, pair, image row), one 4-byte
//     element per thread: the counterpart of the TPU kernel's single-row DMAs;
//   * Alg 2, pass A: one block per tile of kAlg2TileElems tmpFrame elements
//     (16 rows of an 80 x 256 bank), written with 16-byte vector stores;
//   * pass B, both: one block per (pair, image row), one element per thread,
//     summing the G groups in order inside the thread. That loop replaces the
//     TPU grid's sequential innermost group axis, whose VMEM-resident sum has
//     no counterpart across blocks.
// The tile changes no number, so Alg 1 and Alg 2 are bitwise equal. A tuning
// plan's geometry (repro_torch/tune) sets row_tile image rows of pair_tile
// (group, pair) spans a block in the row kernels (for_tile_rows, quant.cuh),
// and an Alg 2 tile of row_tile x W elements in whole float4s over pair_tile
// spans; it too changes no number.
//
// Rounding is the reference's: pass A is f32(exc) - f32(ctl) + offset, rounded
// at the subtraction and at the add; pass B starts from 0, adds the G tmpFrames
// in group order and multiplies by f32(1/G), which the host computes: inside
// jit XLA rewrites the Pallas kernel's "/ G" as that multiply. A true division
// differs from it for every G that is not a power of two. Everything is written
// with _rn intrinsics, which nvcc never contracts or reorders.
//
// Integer sums (int32, or uint16 wrapping at 16 bits) make the tmpFrame of
// that type: pass A narrows each int32 difference to it, pass B adds in it
// and floors the division by G (IntSum, quant.cuh). They take the scalar
// store of pass A in both algorithms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant.cuh"

namespace {

using repro_quant::for_tile_rows;
using repro_quant::in_form;
using repro_quant::row_tile_blocks;
using repro_quant::row_tiles_ok;
using repro_quant::threads_for;

// Alg 2's pass-A tile, from Hopper's limits rather than the TPU's VMEM model:
// 16 bytes is the widest store a thread can issue, so each thread writes
// float4s; a warp's 32 float4 stores then cover four whole 128-byte lines.
// 256 threads (8 warps, so 8 blocks fill an SM's 2048 threads) with four
// float4s each give 4096 elements, 16 KB of tmpFrame per block: 16 image rows
// of an 80 x 256 bank, and 20,000 blocks at the paper's shape, some 150 per SM.
constexpr int kAlg2Threads = 256;
constexpr int kAlg2VecPerThread = 4;
constexpr int64_t kAlg2TileElems = int64_t{kAlg2Threads} * kAlg2VecPerThread * 4;

using repro_quant::IntSum;
using repro_quant::int_pair_diff;

// One tmpFrame element of sum type T: exc - ctl + offset.
template <typename T>
__device__ __forceinline__ T diff(uint16_t c, uint16_t e, float offset) {
  if constexpr (std::is_same_v<T, float>) {
    return __fadd_rn(__fsub_rn(static_cast<float>(e), static_cast<float>(c)), offset);
  } else {
    return int_pair_diff<T>(c, e, static_cast<int32_t>(offset));
  }
}

// Each kernel below has two forms, picked at launch: the untiled one
// (TILED = false), one block per row or tile as before the tuner, and a
// plan's geometry (TILED = true). Both run one body, so they give the same
// bits.

// Alg 1, pass A. Row (gp, h) of the tmpFrame is (span gp = gP + p, image row
// h); its control row is frame 2 gp of the (G, N, H, W) input, the excitation
// row the frame after it. The tiled form covers rt rows of pt spans a block.
template <typename T>
__device__ __forceinline__ void subtract_row(const uint16_t* __restrict__ frames,
                                             T* __restrict__ tmp, int64_t gp, int64_t h,
                                             int height, int width, float offset) {
  const uint16_t* ctl = frames + ((2 * gp) * height + h) * width;
  const uint16_t* exc = ctl + static_cast<int64_t>(height) * width;
  T* dst = tmp + (gp * height + h) * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) dst[x] = diff<T>(ctl[x], exc[x], offset);
}

template <typename T, bool TILED>
__global__ void subtract_rows_kernel(const uint16_t* __restrict__ frames,
                                     T* __restrict__ tmp, int64_t spans, int height,
                                     int width, int rt, int pt, float offset) {
  if constexpr (TILED) {
    for_tile_rows(spans, height, rt, pt, [=](int64_t gp, int64_t h) {
      subtract_row<T>(frames, tmp, gp, h, height, width, offset);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t gp = r / height;
    subtract_row<T>(frames, tmp, gp, r - gp * height, height, width, offset);
  }
}

// Alg 2, pass A. The H*W elements of one (group, pair) span are contiguous in
// the control frame, the excitation frame and the tmpFrame, so a tile is a
// flat run of them: n <= kAlg2TileElems elements from t0. VEC needs span % 4
// == 0 and an 8-byte aligned input (the host checks both), and a float32
// tmpFrame.
template <bool VEC, typename T>
__device__ __forceinline__ void subtract_tile(const uint16_t* __restrict__ frames,
                                              T* __restrict__ tmp, int64_t gp, int64_t span,
                                              int64_t t0, int64_t n, float offset) {
  const uint16_t* ctl = frames + 2 * gp * span + t0;
  const uint16_t* exc = ctl + span;
  T* dst = tmp + gp * span + t0;
  if constexpr (VEC) {
    static_assert(std::is_same_v<T, float>, "the vector store writes float4");
    const int64_t quads = n / 4;
    const ushort4* c4 = reinterpret_cast<const ushort4*>(ctl);
    const ushort4* e4 = reinterpret_cast<const ushort4*>(exc);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kAlg2VecPerThread; ++k) {
      const int64_t q = threadIdx.x + int64_t{k} * kAlg2Threads;
      if (q < quads) {
        const ushort4 c = c4[q];
        const ushort4 e = e4[q];
        d4[q] = make_float4(diff<float>(c.x, e.x, offset), diff<float>(c.y, e.y, offset),
                            diff<float>(c.z, e.z, offset), diff<float>(c.w, e.w, offset));
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kAlg2Threads)
      dst[i] = diff<T>(ctl[i], exc[i], offset);
  }
}

// The untiled form: block b takes tile b % tiles_per_span (kAlg2TileElems
// elements; the last tile of a span may be short) of span b / tiles_per_span.
// The tiled form: tiles of `tile` elements (a multiple of 4), and block b takes
// tile b % tiles_per_span of pt spans from pt (b / tiles_per_span), in passes
// of kAlg2TileElems.
template <bool VEC, typename T, bool TILED>
__global__ void __launch_bounds__(kAlg2Threads)
subtract_tiles_kernel(const uint16_t* __restrict__ frames, T* __restrict__ tmp,
                      int64_t spans, int64_t span, int64_t tile, int64_t tiles_per_span,
                      int pt, float offset) {
  const int64_t sb = blockIdx.x / tiles_per_span;
  const int64_t first = (blockIdx.x - sb * tiles_per_span) * tile;
  if constexpr (TILED) {
    const int64_t end = first + tile < span ? first + tile : span;
    const int64_t gp_end = (sb + 1) * pt < spans ? (sb + 1) * pt : spans;
    for (int64_t gp = sb * pt; gp < gp_end; ++gp) {
      for (int64_t t0 = first; t0 < end; t0 += kAlg2TileElems) {
        const int64_t n = end - t0 < kAlg2TileElems ? end - t0 : kAlg2TileElems;
        subtract_tile<VEC, T>(frames, tmp, gp, span, t0, n, offset);
      }
    }
  } else {
    const int64_t n = span - first < kAlg2TileElems ? span - first : kAlg2TileElems;
    subtract_tile<VEC, T>(frames, tmp, sb, span, first, n, offset);
  }
}

// Pass B, both algorithms. Row (p, h) of the output is (pair p, image row h);
// the same element of group g lies g * plane further on in the tmpFrame. The
// tiled form covers rt rows of pt pairs a block.
template <typename T>
__device__ __forceinline__ void reduce_row(const T* __restrict__ tmp, T* __restrict__ out,
                                           int64_t r, int groups, int64_t plane, int width,
                                           float rcp) {
  const T* src = tmp + r * width;
  T* dst = out + r * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    T acc = 0;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      if constexpr (std::is_same_v<T, float>) {
        acc = __fadd_rn(acc, src[g * plane + x]);
      } else {
        acc = IntSum<T>::add(acc, src[g * plane + x]);
      }
    }
    if constexpr (std::is_same_v<T, float>) {
      dst[x] = __fmul_rn(acc, rcp);
    } else {
      dst[x] = IntSum<T>::div(acc, groups);
    }
  }
}

template <typename T, bool TILED>
__global__ void reduce_rows_kernel(const T* __restrict__ tmp,
                                   T* __restrict__ out, int groups, int64_t pairs,
                                   int height, int width, int rt, int pt, float rcp) {
  const int64_t plane = pairs * height * width;
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      reduce_row<T>(tmp, out, p * height + h, groups, plane, width, rcp);
    });
  } else {
    reduce_row<T>(tmp, out, blockIdx.x, groups, plane, width, rcp);
  }
}

// A launch's tiles (0 = 1), false when invalid for `pairs` x `height` rows.
bool tiles_for(int64_t pairs, int64_t height, int64_t row_tile, int64_t pair_tile, int* rt,
               int* pt) {
  if (row_tile < 0 || pair_tile < 0) return false;
  const int64_t r = row_tile ? row_tile : 1, q = pair_tile ? pair_tile : 1;
  if (!row_tiles_ok(pairs, height, r, q)) return false;
  *rt = static_cast<int>(r);
  *pt = static_cast<int>(q);
  return true;
}

template <typename T>
cudaError_t subtract(const uint16_t* f, void* tmp, int64_t spans, int64_t height,
                     int64_t width, bool burst, float offset, int64_t row_tile,
                     int64_t pair_tile, cudaStream_t s) {
  T* t = static_cast<T*>(tmp);
  int rt, pt;
  if (spans * height > 0x7fffffff || width > 0x7fffffff ||
      !tiles_for(spans, height, row_tile, pair_tile, &rt, &pt))
    return cudaErrorInvalidValue;
  const bool tiled = row_tile != 0 || pair_tile != 0;
  if (!burst) {
    const int w = static_cast<int>(width);
    return in_form(tiled, [&](auto form) {
      subtract_rows_kernel<T, decltype(form)::value>
          <<<static_cast<unsigned>(row_tile_blocks(spans, height, rt, pt)), threads_for(w), 0,
             s>>>(f, t, spans, static_cast<int>(height), w, rt, pt, offset);
    });
  }
  const int64_t span = height * width;
  const int64_t tile = row_tile ? (row_tile * width + 3) / 4 * 4 : kAlg2TileElems;
  const int64_t tiles = (span + tile - 1) / tile;
  const int64_t span_blocks = (spans + pt - 1) / pt;
  if (span_blocks * tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(span_blocks * tiles);
  bool vec = false;
  if constexpr (std::is_same_v<T, float>) {
    vec = span % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 8 == 0 &&
          reinterpret_cast<uintptr_t>(tmp) % 16 == 0;
  }
  return in_form(tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if constexpr (std::is_same_v<T, float>) {
      if (vec) {
        subtract_tiles_kernel<true, T, kTiled><<<blocks, kAlg2Threads, 0, s>>>(
            f, t, spans, span, tile, tiles, pt, offset);
        return;
      }
    }
    subtract_tiles_kernel<false, T, kTiled><<<blocks, kAlg2Threads, 0, s>>>(
        f, t, spans, span, tile, tiles, pt, offset);
  });
}

template <typename T>
cudaError_t reduce(const void* tmp, void* out, int groups, int64_t pairs, int height,
                   int width, int rt, int pt, bool tiled, float rcp, cudaStream_t s) {
  return in_form(tiled, [&](auto form) {
    reduce_rows_kernel<T, decltype(form)::value>
        <<<static_cast<unsigned>(row_tile_blocks(pairs, height, rt, pt)), threads_for(width), 0,
           s>>>(static_cast<const T*>(tmp), static_cast<T*>(out), groups, pairs, height, width,
                rt, pt, rcp);
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of its
// launch (0 = launched). `spans` is G * N/2, the number of (group, pair)
// difference frames; `pairs` is N/2. `acc` is the tmpFrame's and the output's
// AccumCode (quant.cuh). `row_tile` and `pair_tile` (0 = the default
// geometry) set the rows and spans (pass A) or pairs (pass B) a block covers.
extern "C" {

int tmpframe_subtract_launch(const void* frames, void* tmp, int64_t spans,
                             int64_t height, int64_t width, int burst,
                             float offset, int acc, int64_t row_tile, int64_t pair_tile,
                             void* stream) {
  if (spans == 0 || height == 0 || width == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
#define SUBTRACT(T) subtract<T>(f, tmp, spans, height, width, burst, offset, row_tile, pair_tile, s)
  switch (acc) {
    case repro_quant::kAccF32: return SUBTRACT(float);
    case repro_quant::kAccI32: return SUBTRACT(int32_t);
    case repro_quant::kAccU16: return SUBTRACT(uint16_t);
  }
#undef SUBTRACT
  return cudaErrorInvalidValue;
}

int tmpframe_reduce_launch(const void* tmp, void* out, int64_t groups, int64_t pairs,
                           int64_t height, int64_t width, float rcp, int acc,
                           int64_t row_tile, int64_t pair_tile, void* stream) {
  if (pairs == 0 || height == 0 || width == 0) return cudaSuccess;
  int rt, pt;
  if (pairs * height > 0x7fffffff || width > 0x7fffffff || groups < 1 ||
      groups > 0x7fffffff || !tiles_for(pairs, height, row_tile, pair_tile, &rt, &pt))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups), h = static_cast<int>(height);
  const int w = static_cast<int>(width);
  const bool tiled = row_tile != 0 || pair_tile != 0;
#define REDUCE(T) reduce<T>(tmp, out, g, pairs, h, w, rt, pt, tiled, rcp, s)
  switch (acc) {
    case repro_quant::kAccF32: return REDUCE(float);
    case repro_quant::kAccI32: return REDUCE(int32_t);
    case repro_quant::kAccU16: return REDUCE(uint16_t);
  }
#undef REDUCE
  return cudaErrorInvalidValue;
}

}  // extern "C"
