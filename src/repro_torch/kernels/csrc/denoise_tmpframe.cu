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
//   * Alg 1, pass A: one block per (group, pair, image row): the counterpart
//     of the TPU kernel's single-row DMAs;
//   * Alg 2, pass A: one block per tile of kAlg2TileElems tmpFrame elements
//     (16 rows of an 80 x 256 bank);
//   * pass B, both: one block per (pair, image row), each thread summing the
//     G groups of its pixels in order inside the thread. That loop replaces
//     the TPU grid's sequential innermost group axis, whose VMEM-resident sum
//     has no counterpart across blocks.
// Inside a row or a tile each pass has two paths, picked on the host and
// passed as a flag; the launcher refuses a vector launch that its operands
// do not allow (cudaErrorInvalidValue) and never reroutes one:
//   * vector path, float32, float16 and bfloat16 tmpFrames: a thread takes
//     a vector of consecutive pixels. Pass A loads their u16 control and
//     excitation values (8 or 16 bytes each) and stores the tmpFrame's
//     vector (a float4, or 16 bytes of eight halves), kRoundPixels pixels a
//     thread a round with every load of the round issued before any store.
//     Pass B loads 16 bytes of the tmpFrame a group (four float32 pixels or
//     eight halves), the loads of kReduceChunk groups issued together, then
//     adds them in group order. Both need every plane to start on a vector
//     (H*W for pass A, N/2*H*W for pass B a multiple of the vector, and
//     16-byte aligned operands); a row that starts or ends inside a vector
//     takes those pixels in a scalar head and tail, in the same launch.
//     On the H100 one-element accesses held the scalar path to 60 % of the
//     byte bound in Alg 1's pass A and to 81-91 % in pass B (a half warp
//     load moved 64 bytes, half a line); the vector path runs pass A at
//     75-90 % and pass B at 88-91 % (PERF.md section 6). Alg 1's half pass A
//     stays lowest: its 320,000 one-row blocks of one warp each are the
//     paper's single-row transfers.
//   * scalar path, one pixel a thread: integer tmpFrames, and planes or
//     views that the vector path does not take.
// The path and the tile change no number, so Alg 1 and Alg 2 are bitwise
// equal. A tuning plan's geometry (repro_torch/tune) sets row_tile image rows
// of pair_tile (group, pair) spans a block in the row kernels (for_tile_rows,
// quant.cuh), and an Alg 2 tile of row_tile x W elements, rounded up to
// whole vectors of 8, over pair_tile spans; it too changes no number.
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
// and floors the division by G (IntSum, quant.cuh). A float16 or bfloat16
// accumulator makes a tmpFrame of its type, every operation rounded to it
// (quant.cuh Acc); pass B scales by the host's f16(1/G), or divides by G for
// bfloat16. On the vector path the half types run in packed pairs (Half2,
// quant.cuh): each __hsub2_rn, __hadd2_rn and __hmul2_rn is one correctly
// rounded operation on two half values, the bits of the scalar body's float
// operation rounded once to the type, and a u16 value is rounded to the type
// in the packed conversion (exact as a float first). bfloat16 divides by G
// as bf16_quotient (quant.cuh) does: x * f32(1/G) for G <= 64, which rounds
// to the true division's bfloat16 for every bfloat16 x, else truly.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "quant.cuh"

namespace {

using repro_quant::Acc;
using repro_quant::Half2;
using repro_quant::IntSum;
using repro_quant::acc_add;
using repro_quant::acc_scale;
using repro_quant::acc_sub;
using repro_quant::bf16_quotient;
using repro_quant::for_tile_rows;
using repro_quant::in_form;
using repro_quant::int_pair_diff;
using repro_quant::row_tile_blocks;
using repro_quant::row_tiles_ok;
using repro_quant::threads_for;

// Pass A's vector path: kRoundPixels pixels a thread a round, all its loads
// in flight before its stores (four float4s of float32, two 16-byte stores of
// half). Alg 2's tile, from Hopper's limits rather than the TPU's VMEM model:
// 256 threads (8 warps, so 8 blocks fill an SM's 2048 threads) of one round
// each give 4096 elements: 16 image rows of an 80 x 256 bank, and 20,000
// blocks at the paper's shape, some 150 per SM.
constexpr int kRoundPixels = 16;
constexpr int kAlg2Threads = 256;
constexpr int64_t kAlg2TileElems = int64_t{kAlg2Threads} * kRoundPixels;
// Pass B's vector path: the groups whose loads are in flight together.
constexpr int kReduceChunk = 8;

// A float16 or bfloat16 tmpFrame (quant.cuh Acc): every operation rounded to it.
template <typename T>
constexpr bool kHalf = std::is_same_v<T, __half> || std::is_same_v<T, __nv_bfloat16>;
// A tmpFrame type with a vector path.
template <typename T>
constexpr bool kFloat = std::is_same_v<T, float> || kHalf<T>;

// Pixels of a thread's vector on both passes: 16 bytes of tmpFrame, four
// float32 or eight half pixels (the host's VECTOR_PIXELS). Four half pixels a
// thread (8-byte accesses) made Alg 1's pass A 0.6 % slower on the H100.
template <typename T>
constexpr int kVecPixels = 16 / static_cast<int>(sizeof(T));

// One tmpFrame element of sum type T: exc - ctl + offset.
template <typename T>
__device__ __forceinline__ T diff(uint16_t c, uint16_t e, float offset) {
  if constexpr (std::is_same_v<T, float>) {
    return __fadd_rn(__fsub_rn(static_cast<float>(e), static_cast<float>(c)), offset);
  } else if constexpr (kHalf<T>) {
    const float d = acc_sub<T>(Acc<T>::round(static_cast<float>(e)),
                               Acc<T>::round(static_cast<float>(c)));
    return Acc<T>::store(acc_add<T>(d, offset));
  } else {
    return int_pair_diff<T>(c, e, static_cast<int32_t>(offset));
  }
}

template <typename P>
__device__ __forceinline__ P from_bits(uint32_t w) {
  P p;
  memcpy(&p, &w, sizeof(p));
  return p;
}
template <typename P>
__device__ __forceinline__ uint32_t to_bits(P p) {
  uint32_t w;
  memcpy(&w, &p, sizeof(w));
  return w;
}

// V consecutive u16 pixels (V = 4 or 8) in one 8- or 16-byte load.
template <int V>
struct U16Vec {
  uint32_t w[V / 2];
  __device__ __forceinline__ uint16_t operator[](int k) const {
    return static_cast<uint16_t>((k & 1) ? w[k >> 1] >> 16 : w[k >> 1] & 0xFFFFu);
  }
};

template <int V>
__device__ __forceinline__ U16Vec<V> load_u16(const uint16_t* __restrict__ plane, int64_t q) {
  static_assert(V == 4 || V == 8, "a u16 vector is 4 or 8 pixels");
  U16Vec<V> x;
  if constexpr (V == 8) {
    const uint4 a = reinterpret_cast<const uint4*>(plane)[q];
    x.w[0] = a.x, x.w[1] = a.y, x.w[2] = a.z, x.w[3] = a.w;
  } else {
    const uint2 a = reinterpret_cast<const uint2*>(plane)[q];
    x.w[0] = a.x, x.w[1] = a.y;
  }
  return x;
}

// Vector q of a tmpFrame plane (pixels [V q, V q + V)): exc - ctl + offset,
// as diff<T> computes it pixel by pixel.
template <typename T, int V>
__device__ __forceinline__ void store_diff(T* __restrict__ plane, int64_t q, const U16Vec<V>& c,
                                           const U16Vec<V>& e, float offset) {
  if constexpr (std::is_same_v<T, float>) {
    float4* d4 = reinterpret_cast<float4*>(plane) + q * (V / 4);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      d4[i] = make_float4(diff<float>(c[4 * i], e[4 * i], offset),
                          diff<float>(c[4 * i + 1], e[4 * i + 1], offset),
                          diff<float>(c[4 * i + 2], e[4 * i + 2], offset),
                          diff<float>(c[4 * i + 3], e[4 * i + 3], offset));
  } else {
    using H = Half2<T>;
    const typename H::T off = H::splat(offset);
    uint32_t r[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const typename H::T c2 = H::pack(static_cast<float>(c[2 * j]), static_cast<float>(c[2 * j + 1]));
      const typename H::T e2 = H::pack(static_cast<float>(e[2 * j]), static_cast<float>(e[2 * j + 1]));
      r[j] = to_bits(__hadd2_rn(__hsub2_rn(e2, c2), off));
    }
    if constexpr (V == 8) {
      reinterpret_cast<uint4*>(plane)[q] = make_uint4(r[0], r[1], r[2], r[3]);
    } else {
      reinterpret_cast<uint2*>(plane)[q] = make_uint2(r[0], r[1]);
    }
  }
}

// The vector layout of n pixels from pixel t0 of a plane that starts on a
// vector of V pixels: a scalar head up to the first vector boundary, `vecs`
// whole vectors from vector `first`, a scalar tail; `edge` pixels in head
// and tail, the i-th at edge_pixel(i).
template <int V>
struct Run {
  int64_t t0, head, first, vecs, tail0;
  int edge;
  __device__ __forceinline__ Run(int64_t start, int64_t n) : t0(start) {
    const int64_t to_boundary = (V - start % V) % V;
    head = to_boundary < n ? to_boundary : n;
    first = (start + head) / V;
    vecs = (n - head) / V;
    tail0 = start + head + vecs * V;
    edge = static_cast<int>(head + (start + n - tail0));
  }
  __device__ __forceinline__ int64_t edge_pixel(int i) const {
    return i < head ? t0 + i : tail0 + (i - head);
  }
};

// Pass A on the vector path: pixels [t0, t0 + n) of span gp = gP + p, whose
// control frame is frame 2 gp of the (G, N, H, W) input and excitation frame
// the one after it; H*W = span is a multiple of the vector, so the frames and
// the tmpFrame share its boundaries.
template <typename T>
__device__ __forceinline__ void subtract_run(const uint16_t* __restrict__ frames,
                                             T* __restrict__ tmp, int64_t gp, int64_t span,
                                             int64_t t0, int64_t n, float offset) {
  constexpr int V = kVecPixels<T>;
  constexpr int K = kRoundPixels / V;
  const uint16_t* ctl = frames + 2 * gp * span;
  const uint16_t* exc = ctl + span;
  T* dst = tmp + gp * span;
  const Run<V> run(t0, n);
  for (int i = threadIdx.x; i < run.edge; i += blockDim.x) {
    const int64_t x = run.edge_pixel(i);
    dst[x] = diff<T>(ctl[x], exc[x], offset);
  }
  for (int64_t q0 = threadIdx.x; q0 < run.vecs; q0 += int64_t{K} * blockDim.x) {
    U16Vec<V> c[K], e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {  // every load of the round before any store
      const int64_t q = q0 + int64_t{k} * blockDim.x;
      if (q < run.vecs) {
        c[k] = load_u16<V>(ctl, run.first + q);
        e[k] = load_u16<V>(exc, run.first + q);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t q = q0 + int64_t{k} * blockDim.x;
      if (q < run.vecs) store_diff<T, V>(dst, run.first + q, c[k], e[k], offset);
    }
  }
}

// Each kernel below has two forms, picked at launch: the untiled one
// (TILED = false), one block per row or tile, and a plan's geometry
// (TILED = true). Both run one body, so they give the same bits.

// Alg 1, pass A, scalar path: row (gp, h) of the tmpFrame, one pixel a thread.
template <typename T>
__device__ __forceinline__ void subtract_row(const uint16_t* __restrict__ frames,
                                             T* __restrict__ tmp, int64_t gp, int64_t h,
                                             int height, int width, float offset) {
  const uint16_t* ctl = frames + ((2 * gp) * height + h) * width;
  const uint16_t* exc = ctl + static_cast<int64_t>(height) * width;
  T* dst = tmp + (gp * height + h) * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) dst[x] = diff<T>(ctl[x], exc[x], offset);
}

// Alg 1, pass A: row (gp, h) a block; the tiled form covers rt rows of pt
// spans a block.
template <typename T, bool VEC, bool TILED>
__global__ void __launch_bounds__(256)
subtract_rows_kernel(const uint16_t* __restrict__ frames, T* __restrict__ tmp, int64_t spans,
                     int height, int width, int rt, int pt, float offset) {
  const auto row = [=](int64_t gp, int64_t h) {
    if constexpr (VEC) {
      subtract_run<T>(frames, tmp, gp, int64_t{height} * width, h * width, width, offset);
    } else {
      subtract_row<T>(frames, tmp, gp, h, height, width, offset);
    }
  };
  if constexpr (TILED) {
    for_tile_rows(spans, height, rt, pt, row);
  } else {
    const int64_t r = blockIdx.x;
    const int64_t gp = r / height;
    row(gp, r - gp * height);
  }
}

// Alg 2, pass A. The H*W elements of one (group, pair) span are contiguous in
// the control frame, the excitation frame and the tmpFrame, so a tile is a
// flat run of them: n <= kAlg2TileElems elements from t0.
template <bool VEC, typename T>
__device__ __forceinline__ void subtract_tile(const uint16_t* __restrict__ frames,
                                              T* __restrict__ tmp, int64_t gp, int64_t span,
                                              int64_t t0, int64_t n, float offset) {
  if constexpr (VEC) {
    subtract_run<T>(frames, tmp, gp, span, t0, n, offset);
  } else {
    const uint16_t* ctl = frames + 2 * gp * span + t0;
    const uint16_t* exc = ctl + span;
    T* dst = tmp + gp * span + t0;
    for (int64_t i = threadIdx.x; i < n; i += kAlg2Threads)
      dst[i] = diff<T>(ctl[i], exc[i], offset);
  }
}

// The untiled form: block b takes tile b % tiles_per_span (kAlg2TileElems
// elements; the last tile of a span may be short) of span b / tiles_per_span.
// The tiled form: tiles of `tile` elements (a multiple of 8), and block b
// takes tile b % tiles_per_span of pt spans from pt (b / tiles_per_span), in
// passes of kAlg2TileElems.
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

// Pass B, one pixel: element x of the output plane, whose group g lies
// g * plane further on in the tmpFrame, summed from zero in group order, then
// x / G (scalar path, and the vector path's head and tail).
template <typename T>
__device__ __forceinline__ T reduce_pixel(const T* __restrict__ tmp, int64_t x, int groups,
                                          int64_t plane, float rcp) {
  if constexpr (kHalf<T>) {  // in order from zero, then * (1/G) or / G (acc_scale)
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) acc = acc_add<T>(acc, Acc<T>::load(tmp[g * plane + x]));
    return Acc<T>::store(acc_scale<T>(acc, rcp, static_cast<float>(groups)));
  } else {
    T acc = 0;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      if constexpr (std::is_same_v<T, float>) {
        acc = __fadd_rn(acc, tmp[g * plane + x]);
      } else {
        acc = IntSum<T>::add(acc, tmp[g * plane + x]);
      }
    }
    if constexpr (std::is_same_v<T, float>) {
      return __fmul_rn(acc, rcp);
    } else {
      return IntSum<T>::div(acc, groups);
    }
  }
}

// Pass B's sums of one 16-byte vector, from zero: float32 adds, or packed
// pairs of a half type (Half2, quant.cuh), each one correctly rounded
// operation, so reduce_pixel's bits.
template <typename T>
struct VecSum {
  using H = Half2<T>;
  typename H::T s[4];
  __device__ __forceinline__ VecSum() {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = H::splat(0.0f);
  }
  __device__ __forceinline__ void add(const uint4& x) {
    s[0] = __hadd2_rn(s[0], from_bits<typename H::T>(x.x));
    s[1] = __hadd2_rn(s[1], from_bits<typename H::T>(x.y));
    s[2] = __hadd2_rn(s[2], from_bits<typename H::T>(x.z));
    s[3] = __hadd2_rn(s[3], from_bits<typename H::T>(x.w));
  }
  // x / G: * f16(1/G) for float16; bfloat16 by bf16_quotient
  __device__ __forceinline__ typename H::T scaled(typename H::T x, float rcp, float groups,
                                                  bool by_product) const {
    if constexpr (Acc<T>::kContracts) {
      return __hmul2_rn(x, H::splat(rcp));
    } else if (by_product) {
      return H::pack(bf16_quotient<true>(__low2float(x), groups, rcp),
                     bf16_quotient<true>(__high2float(x), groups, rcp));
    } else {
      return H::pack(bf16_quotient<false>(__low2float(x), groups, rcp),
                     bf16_quotient<false>(__high2float(x), groups, rcp));
    }
  }
  __device__ __forceinline__ uint4 average(float rcp, float groups, bool by_product) const {
    return make_uint4(to_bits(scaled(s[0], rcp, groups, by_product)),
                      to_bits(scaled(s[1], rcp, groups, by_product)),
                      to_bits(scaled(s[2], rcp, groups, by_product)),
                      to_bits(scaled(s[3], rcp, groups, by_product)));
  }
};

template <>
struct VecSum<float> {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __device__ __forceinline__ void add(const uint4& x) {
    s[0] = __fadd_rn(s[0], __uint_as_float(x.x));
    s[1] = __fadd_rn(s[1], __uint_as_float(x.y));
    s[2] = __fadd_rn(s[2], __uint_as_float(x.z));
    s[3] = __fadd_rn(s[3], __uint_as_float(x.w));
  }
  __device__ __forceinline__ uint4 average(float rcp, float, bool) const {
    return make_uint4(__float_as_uint(__fmul_rn(s[0], rcp)), __float_as_uint(__fmul_rn(s[1], rcp)),
                      __float_as_uint(__fmul_rn(s[2], rcp)), __float_as_uint(__fmul_rn(s[3], rcp)));
  }
};

// Pass B on the vector path: output pixels [t0, t0 + n); the plane is a
// multiple of the vector, so every group's tmpFrame shares its boundaries.
template <typename T>
__device__ __forceinline__ void reduce_run(const T* __restrict__ tmp, T* __restrict__ out,
                                           int64_t t0, int64_t n, int groups, int64_t plane,
                                           float rcp) {
  constexpr int V = kVecPixels<T>;
  const Run<V> run(t0, n);
  for (int i = threadIdx.x; i < run.edge; i += blockDim.x) {
    const int64_t x = run.edge_pixel(i);
    out[x] = reduce_pixel<T>(tmp, x, groups, plane, rcp);
  }
  const uint4* src = reinterpret_cast<const uint4*>(tmp);
  const int64_t stride = plane / V;  // vectors a group
  const float g = static_cast<float>(groups);
  const bool by_product = groups <= 64;  // bfloat16's x / G (bf16_quotient)
  for (int64_t q = run.first + threadIdx.x; q < run.first + run.vecs; q += blockDim.x) {
    VecSum<T> acc;
    for (int g0 = 0; g0 < groups; g0 += kReduceChunk) {
      uint4 x[kReduceChunk];
#pragma unroll
      for (int u = 0; u < kReduceChunk; ++u)  // every load of the chunk before any add
        if (g0 + u < groups) x[u] = src[(g0 + u) * stride + q];
#pragma unroll
      for (int u = 0; u < kReduceChunk; ++u)
        if (g0 + u < groups) acc.add(x[u]);
    }
    reinterpret_cast<uint4*>(out)[q] = acc.average(rcp, g, by_product);
  }
}

// Pass B, both algorithms. Row (p, h) of the output is (pair p, image row h)
// a block; the tiled form covers rt rows of pt pairs a block.
template <typename T, bool VEC, bool TILED>
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const T* __restrict__ tmp, T* __restrict__ out, int groups, int64_t pairs,
                   int height, int width, int rt, int pt, float rcp) {
  const int64_t plane = pairs * height * width;
  const auto row = [=](int64_t p, int64_t h) {
    const int64_t t0 = (p * height + h) * width;
    if constexpr (VEC) {
      reduce_run<T>(tmp, out, t0, width, groups, plane, rcp);
    } else {
      for (int x = threadIdx.x; x < width; x += blockDim.x)
        out[t0 + x] = reduce_pixel<T>(tmp, t0 + x, groups, plane, rcp);
    }
  };
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, row);
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    row(p, r - p * height);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether a vector path of V pixels takes these operands: planes of `plane`
// elements, a multiple of the vector, and both operands 16-byte aligned.
template <int V>
bool vector_ok(int64_t plane, const void* a, const void* b) {
  return plane % V == 0 && aligned16(a) && aligned16(b);
}

template <typename T>
cudaError_t subtract(const uint16_t* f, void* tmp, int64_t spans, int64_t height,
                     int64_t width, bool burst, bool vec, float offset, int64_t row_tile,
                     int64_t pair_tile, cudaStream_t s) {
  T* t = static_cast<T*>(tmp);
  int rt, pt;
  if (spans * height > 0x7fffffff || width > 0x7fffffff ||
      !tiles_for(spans, height, row_tile, pair_tile, &rt, &pt))
    return cudaErrorInvalidValue;
  const int64_t span = height * width;
  if constexpr (kFloat<T>) {
    if (vec && !vector_ok<kVecPixels<T>>(span, f, tmp)) return cudaErrorInvalidValue;
  } else {
    if (vec) return cudaErrorInvalidValue;  // integer tmpFrames take the scalar path
  }
  const bool tiled = row_tile != 0 || pair_tile != 0;
  if (!burst) {
    const int w = static_cast<int>(width);
    const unsigned blocks = static_cast<unsigned>(row_tile_blocks(spans, height, rt, pt));
    return in_form(tiled, [&](auto form) {
      constexpr bool kTiled = decltype(form)::value;
      if constexpr (kFloat<T>) {
        if (vec) {
          constexpr int V = kVecPixels<T>;
          subtract_rows_kernel<T, true, kTiled><<<blocks, threads_for((w + V - 1) / V), 0, s>>>(
              f, t, spans, static_cast<int>(height), w, rt, pt, offset);
          return;
        }
      }
      subtract_rows_kernel<T, false, kTiled><<<blocks, threads_for(w), 0, s>>>(
          f, t, spans, static_cast<int>(height), w, rt, pt, offset);
    });
  }
  const int64_t tile = row_tile ? (row_tile * width + 7) / 8 * 8 : kAlg2TileElems;
  const int64_t tiles = (span + tile - 1) / tile;
  const int64_t span_blocks = (spans + pt - 1) / pt;
  if (span_blocks * tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(span_blocks * tiles);
  return in_form(tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if constexpr (kFloat<T>) {
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
                   int width, bool vec, int rt, int pt, bool tiled, float rcp, cudaStream_t s) {
  if constexpr (kFloat<T>) {
    if (vec && !vector_ok<kVecPixels<T>>(pairs * height * width, tmp, out))
      return cudaErrorInvalidValue;
  } else {
    if (vec) return cudaErrorInvalidValue;  // integer tmpFrames take the scalar path
  }
  const unsigned blocks = static_cast<unsigned>(row_tile_blocks(pairs, height, rt, pt));
  const T* src = static_cast<const T*>(tmp);
  T* dst = static_cast<T*>(out);
  return in_form(tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if constexpr (kFloat<T>) {
      if (vec) {
        constexpr int V = kVecPixels<T>;
        reduce_rows_kernel<T, true, kTiled><<<blocks, threads_for((width + V - 1) / V), 0, s>>>(
            src, dst, groups, pairs, height, width, rt, pt, rcp);
        return;
      }
    }
    reduce_rows_kernel<T, false, kTiled><<<blocks, threads_for(width), 0, s>>>(
        src, dst, groups, pairs, height, width, rt, pt, rcp);
  });
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of its
// launch (0 = launched). `spans` is G * N/2, the number of (group, pair)
// difference frames; `pairs` is N/2. `vector` picks the vector path (the host's
// tmpframe_path), which a float tmpFrame takes; `acc` is the tmpFrame's and
// the output's AccumCode (quant.cuh). `row_tile` and `pair_tile` (0 = the
// default geometry) set the rows and spans (pass A) or pairs (pass B) a block
// covers.
extern "C" {

int tmpframe_subtract_launch(const void* frames, void* tmp, int64_t spans,
                             int64_t height, int64_t width, int burst, int vector,
                             float offset, int acc, int64_t row_tile, int64_t pair_tile,
                             void* stream) {
  if (spans == 0 || height == 0 || width == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
#define SUBTRACT(T) \
  subtract<T>(f, tmp, spans, height, width, burst, vector, offset, row_tile, pair_tile, s)
  switch (acc) {
    case repro_quant::kAccF32: return SUBTRACT(float);
    case repro_quant::kAccI32: return SUBTRACT(int32_t);
    case repro_quant::kAccU16: return SUBTRACT(uint16_t);
    case repro_quant::kAccF16: return SUBTRACT(__half);
    case repro_quant::kAccBF16: return SUBTRACT(__nv_bfloat16);
  }
#undef SUBTRACT
  return cudaErrorInvalidValue;
}

int tmpframe_reduce_launch(const void* tmp, void* out, int64_t groups, int64_t pairs,
                           int64_t height, int64_t width, int vector, float rcp, int acc,
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
#define REDUCE(T) reduce<T>(tmp, out, g, pairs, h, w, vector, rt, pt, tiled, rcp, s)
  switch (acc) {
    case repro_quant::kAccF32: return REDUCE(float);
    case repro_quant::kAccI32: return REDUCE(int32_t);
    case repro_quant::kAccU16: return REDUCE(uint16_t);
    case repro_quant::kAccF16: return REDUCE(__half);
    case repro_quant::kAccBF16: return REDUCE(__nv_bfloat16);
  }
#undef REDUCE
  return cudaErrorInvalidValue;
}

}  // extern "C"
