// Hopper kernels for the PRISM subtract-and-average family (paper Alg 3 / 3 v2).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   alg3_stream_step            <- src/repro/kernels/denoise_stream.py    alg3_stream_step (_alg3_step_kernel)
//   alg3_subtract_average       <- src/repro/kernels/denoise_stream.py    alg3_subtract_average (_alg3_kernel)
//   multibank_stream_step       <- src/repro/kernels/denoise_multibank.py multibank_stream_step (_mb_step_kernel)
//   multibank_subtract_average  <- src/repro/kernels/denoise_multibank.py multibank_subtract_average (_mb_kernel)
// and fuses the shared dequantization prologue quant.pair_diff_block (B1,
// the __device__ function pair_diff of quant.cuh) into each of them.
//
// Bound: HBM bytes. Per output pixel a step reads two wire pixels (2 x 1, 1.5
// or 2 bytes) and reads + writes one float32 of running sum, for about five
// floating-point operations: some 0.4 operations per byte, two orders of
// magnitude below the ridge of an H100. The only lever is bytes, so every
// input byte is read once and every output written once.
//
// Design of the step (B2/B4), chosen on the host for each launch:
//   * vector path, for u16 and u8 into a float32 sum where every plane
//     allows it (H * W a multiple of 8, the frames aligned to the width of
//     their vector load, the sum to 16 bytes): a pair's control plane
//     frames[2p], excitation plane frames[2p + 1] and sum plane sum[p] are
//     each one contiguous run of H * W pixels, read as 8-pixel vectors (u16:
//     one 16-byte load per frame, u8: one 8-byte load; the sum: two float4
//     loads and stores). Each thread takes two vectors of a plane and issues
//     all their loads before it computes, so four wire loads and four sum
//     loads (up to 128 bytes) are in flight per thread. The grid is
//     (vectors / 512, pairs): no division in the index, and at the paper's
//     shape 2,500 blocks of 256 threads. (The scalar body below keeps one 2-
//     to 4-byte load per thread in flight, in 40,000 one-row blocks at that
//     shape: too few bytes in flight to cover HBM latency, 68-70 % of the
//     byte bound on the H100.)
//   * scalar path, on every other shape (a ragged plane, an unaligned view),
//     for half sums and for p12, whose 12-byte vector no single load takes
//     (a warp-wide load handed round through shared memory gained about 2 %
//     on the H100, within the spread between runs; the one-shot's p12
//     vector below is 16 pixels): one thread per output pixel (per pixel pair
//     for p12, whose 3 wire bytes hold two pixels), one block per output row
//     (pair, image row), threads along W so that a warp's loads and stores
//     are contiguous (coalesced). It is part of the contract, not a
//     fallback: the host sends only shapes the vector path cannot take here.
//
// Design of the one-shot (B3/B5): the G groups are a loop inside the thread,
// the sum in registers across it. This replaces the TPU's sequential
// innermost grid axis, whose VMEM-resident accumulator has no counterpart
// across blocks. The bank axis is one more index folded into the pair axis,
// so banks never touch each other's data, as on the TPU grid. Two paths,
// chosen on the host for each launch (denoise_stream.oneshot_path):
//   * vector path, for every wire format and float sum where every plane
//     allows it (H * W a multiple of the vector, the frames aligned for its
//     loads, the output to 16 bytes): a thread owns a run of consecutive
//     pixels of one output plane, 8 for u16 (one 16-byte load a frame) and
//     16 for u8 (one 16-byte load) and p12 (24 bytes in three 8-byte loads,
//     so 8-byte aligned planes: H * W a multiple of 16), and issues the 2 x
//     4 wire loads of four groups before it folds them. Outputs leave as
//     float4 or 16-byte stores of eight halves. One-byte loads held the
//     scalar one-shot to 30-32 % of the byte bound for u8 and 42-52 % for
//     p12 (slower than u16, which moves more bytes): a warp instruction moved
//     32 bytes, and p12 took six of them a pixel pair.
//     Half sums run in __half2 / __nv_bfloat162 pairs: each add, subtract,
//     multiply and float16 FMA is one correctly rounded packed operation
//     (_rn: never contracted), the bits of the scalar body's float operation
//     rounded once to the type (quant.cuh Acc), in a fraction of its
//     instructions; a wire value is rounded to the type in the packed
//     conversion. bfloat16 divides x / G as x * f32(1/G) for G <= 64, which
//     rounds to the bfloat16 the true division gives for every bfloat16 x
//     (bf16_quotient, quant.cuh, held exhaustively on the card).
//   * scalar path, on a ragged plane or an unaligned view, and for integer
//     sums: the step's scalar layout, one thread per output pixel (pair).
//     The kernel refuses a vector launch on planes that do not allow it
//     (cudaErrorInvalidValue); it never reroutes one.

// Launch geometry is a tuning plan's (repro_torch/tune): `row_tile` image rows
// of `pair_tile` pairs a block on the scalar layouts (for_tile_rows,
// quant.cuh), and on the step's vector path a share of row_tile x W pixels a
// block, in whole vectors, over pair_tile pairs. With no plan (0 from the
// host) each kernel runs its untiled form, the layouts above, unchanged. The
// one-shot's vector path has one geometry and takes no plan: its vectors
// share nothing, so a plan can only idle threads or leave a partial pass,
// and each of the step's plans at the paper's shape made it 1-37 % slower
// on the H100 (PERF.md section 6). A geometry moves work between blocks and
// never changes a pixel's arithmetic: both forms run one row body, so every
// geometry gives the same bits.
//
// Integer sums (int32, or uint16 wrapping at 16 bits: the paper's u16-container
// overflow past G = 8) take u16 or p12 wire and one layout, the scalar one, in
// kernels of their own: they are the reference's contract, not its speed path.
// Their arithmetic is IntSum's (quant.cuh): the pair difference in int32,
// narrowed to the sum type; the divide-first fold adds floor(d / G); the final
// division floors. float16 and bfloat16 sums take the step's scalar layout
// and the one-shot's two paths, templated on the sum's type (quant.cuh Acc):
// each operation rounded to it, a float16 fold one __hfma, a bfloat16 one a
// true division (on the one-shot's vector path bf16_quotient) and an add.
//
// Rounding is part of the contract: the reference's jitted kernels compute
// (a) the u8 dequant as fma(e, S, -(c*S)) + offset (quant.cuh), (b) x / G as
// x * f32(1/G), and (c) the divide-first fold s + d / G as fma(d, 1/G, s).
// Each is written here with _rn intrinsics, which nvcc never contracts or
// reorders, so the default -fmad=true cannot change a result. The host passes
// 1/G already rounded to float32.

#include "quant.cuh"

namespace {

using namespace repro_quant;

template <bool DIVIDE_FIRST>
__device__ __forceinline__ float fold(float s, float d, float rcp) {
  if constexpr (DIVIDE_FIRST) return __fmaf_rn(d, rcp, s);
  return __fadd_rn(s, d);
}

// The row kernels below have two forms, picked at launch: the default
// layout (TILED = false), one block per output row (pair or span p, image row
// h) from the row's index blockIdx.x, as before the tuner; and a plan's
// geometry (TILED = true), rt x pt rows a block (for_tile_rows, quant.cuh).
// Both run one row body, so a row's arithmetic is the same in either.

// B2/B4, scalar path: fold one group into the running sum, in place. Row
// (pair p, image row h) spans all banks: a (B, N, H, wire) group is the same
// memory as (B*N, H, wire), so the bank axis folds into the pair axis.
// A is the sum's type (float, __half or __nv_bfloat16, quant.cuh Acc); for
// float the row is the float32 arithmetic above, operation for operation.
template <int FMT, bool DIVIDE_FIRST, typename A>
__device__ __forceinline__ void step_row(const uint8_t* __restrict__ frames,
                                         A* __restrict__ sum, int64_t p, int64_t h,
                                         int height, int items, int64_t row_bytes,
                                         float offset, float u8_scale, float rcp,
                                         float groups, bool final_div) {
  constexpr int P = Item<FMT>::kPixels;
  const uint8_t* ctl = frames + ((2 * p) * height + h) * row_bytes;
  const uint8_t* exc = ctl + height * row_bytes;
  A* out = sum + (p * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    float d[P];
    pair_diff_as<FMT, A>(ctl, exc, x, offset, u8_scale, d);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float t = acc_fold<A, DIVIDE_FIRST>(Acc<A>::load(out[x * P + k]), d[k], rcp, groups);
      if constexpr (!DIVIDE_FIRST) {
        if (final_div) t = acc_scale<A>(t, rcp, groups);
      }
      out[x * P + k] = Acc<A>::store(t);
    }
  }
}

template <int FMT, bool DIVIDE_FIRST, bool TILED, typename A>
__global__ void stream_step_kernel(const uint8_t* __restrict__ frames,
                                   A* __restrict__ sum, int64_t pairs, int height,
                                   int items, int64_t row_bytes, int rt, int pt, float offset,
                                   float u8_scale, float rcp, float groups, bool final_div) {
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      step_row<FMT, DIVIDE_FIRST, A>(frames, sum, p, h, height, items, row_bytes, offset,
                                     u8_scale, rcp, groups, final_div);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    step_row<FMT, DIVIDE_FIRST, A>(frames, sum, p, r - p * height, height, items, row_bytes,
                                   offset, u8_scale, rcp, groups, final_div);
  }
}

// B2/B4, vector path (u16, u8). Default layout: block (x, y) takes vectors
// [512x, 512x + 512) of the planes of pair y (and of y + gridDim.y, ... when
// there are more pairs than a grid row holds); thread i takes vectors 512x + i
// and 512x + 256 + i. A plan's geometry: block (x, y) takes a share of `share`
// vectors, [share x, share x + share), of pt consecutive pairs from pt y (and
// from pt (y + gridDim.y), ...), walking its share 512 vectors at a time.
constexpr int kVecThreads = 256;
constexpr int kVecPerThread = 2;
constexpr int kVecPerBlock = kVecThreads * kVecPerThread;

// Fold vectors v0 and v0 + 256 (those below `end`) of one pair's planes.
template <int FMT, bool DIVIDE_FIRST>
__device__ __forceinline__ void fold_vectors(const uint8_t* __restrict__ ctl,
                                             const uint8_t* __restrict__ exc,
                                             float4* __restrict__ out, int64_t v0,
                                             int64_t end, float offset, float u8_scale,
                                             float rcp, bool final_div) {
  Wire8<FMT> c[kVecPerThread], e[kVecPerThread];
  float4 lo[kVecPerThread], hi[kVecPerThread];
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {  // every load before any use
    const int64_t v = v0 + u * kVecThreads;
    if (v < end) {
      c[u] = load8<FMT>(ctl, v);
      e[u] = load8<FMT>(exc, v);
      lo[u] = out[2 * v];
      hi[u] = out[2 * v + 1];
    }
  }
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int64_t v = v0 + u * kVecThreads;
    if (v < end) {
      float d[8];
      pair_diff8<FMT>(c[u], e[u], offset, u8_scale, d);
      float s[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w, hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] = fold<DIVIDE_FIRST>(s[k], d[k], rcp);
        if constexpr (!DIVIDE_FIRST) {
          if (final_div) s[k] = __fmul_rn(s[k], rcp);
        }
      }
      out[2 * v] = make_float4(s[0], s[1], s[2], s[3]);
      out[2 * v + 1] = make_float4(s[4], s[5], s[6], s[7]);
    }
  }
}

template <int FMT, bool DIVIDE_FIRST, bool TILED>
__global__ void __launch_bounds__(kVecThreads)
    stream_step_vec_kernel(const uint8_t* __restrict__ frames, float* __restrict__ sum,
                           int64_t pairs, int64_t vectors, int64_t share, int pt,
                           int64_t plane_bytes, float offset, float u8_scale, float rcp,
                           bool final_div) {
  if constexpr (TILED) {
    const int64_t first = static_cast<int64_t>(blockIdx.x) * share;
    const int64_t end = first + share < vectors ? first + share : vectors;
    for (int64_t p0 = static_cast<int64_t>(blockIdx.y) * pt; p0 < pairs;
         p0 += static_cast<int64_t>(gridDim.y) * pt) {
      const int64_t p_end = p0 + pt < pairs ? p0 + pt : pairs;
      for (int64_t p = p0; p < p_end; ++p) {
        const uint8_t* ctl = frames + 2 * p * plane_bytes;
        float4* out = reinterpret_cast<float4*>(sum) + p * vectors * 2;
        for (int64_t v0 = first + threadIdx.x; v0 < end; v0 += kVecPerBlock)
          fold_vectors<FMT, DIVIDE_FIRST>(ctl, ctl + plane_bytes, out, v0, end, offset,
                                          u8_scale, rcp, final_div);
      }
    }
  } else {
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kVecPerBlock + threadIdx.x;
    for (int64_t p = blockIdx.y; p < pairs; p += gridDim.y) {
      const uint8_t* ctl = frames + 2 * p * plane_bytes;
      fold_vectors<FMT, DIVIDE_FIRST>(ctl, ctl + plane_bytes,
                                      reinterpret_cast<float4*>(sum) + p * vectors * 2, v0,
                                      vectors, offset, u8_scale, rcp, final_div);
    }
  }
}

// B3/B5: one-shot average over G groups. Row (bp, h) is (bank b, pair p, row
// h) with bp = b * pairs + p. The sum of one output pixel stays in registers
// across the group loop.
template <int FMT, bool DIVIDE_FIRST, typename A>
__device__ __forceinline__ void average_row(const uint8_t* __restrict__ frames,
                                            A* __restrict__ out, int64_t bp, int64_t h,
                                            int groups, int pairs, int height, int items,
                                            int64_t row_bytes, float offset, float u8_scale,
                                            float rcp) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t group_bytes = 2 * static_cast<int64_t>(pairs) * height * row_bytes;
  const uint8_t* base = frames + b * groups * group_bytes + ((2 * p) * height + h) * row_bytes;
  const float gf = static_cast<float>(groups);
  A* dst = out + (bp * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    float acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      const uint8_t* ctl = base + g * group_bytes;
      float d[P];
      pair_diff_as<FMT, A>(ctl, ctl + height * row_bytes, x, offset, u8_scale, d);
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = acc_fold<A, DIVIDE_FIRST>(acc[k], d[k], rcp, gf);
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      dst[x * P + k] = Acc<A>::store(DIVIDE_FIRST ? acc[k] : acc_scale<A>(acc[k], rcp, gf));
  }
}

template <int FMT, bool DIVIDE_FIRST, bool TILED, typename A>
__global__ void subtract_average_kernel(const uint8_t* __restrict__ frames,
                                        A* __restrict__ out, int64_t bank_pairs,
                                        int groups, int pairs, int height, int items,
                                        int64_t row_bytes, int rt, int pt, float offset,
                                        float u8_scale, float rcp) {
  if constexpr (TILED) {
    for_tile_rows(bank_pairs, height, rt, pt, [=](int64_t bp, int64_t h) {
      average_row<FMT, DIVIDE_FIRST, A>(frames, out, bp, h, groups, pairs, height, items,
                                        row_bytes, offset, u8_scale, rcp);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t bp = r / height;
    average_row<FMT, DIVIDE_FIRST, A>(frames, out, bp, r - bp * height, groups, pairs,
                                      height, items, row_bytes, offset, u8_scale, rcp);
  }
}

// B3/B5, vector path. A thread owns one vector (WireVec, quant.cuh: 8 u16
// pixels, or 16 u8 or p12 pixels) of one output plane and keeps its sums in
// registers across the G groups; it issues the wire loads of kGroupChunk
// groups (2 x kGroupChunk wide loads) before it folds them, in group order.
// Block (x, y) takes vectors [256x, 256x + 256) of bank-pair y (and y +
// gridDim.y, ...): no division in the index.
constexpr int kOneThreads = 256;
constexpr int kGroupChunk = 4;

// The running sums of one vector in A's arithmetic: float for float32 (the
// scalar body's operations, operation for operation), else pairs of A
// (Half2, quant.cuh) with one correctly rounded operation where the scalar
// body rounds a float one to A: the same bits (quant.cuh Acc).
template <int FMT, bool DIVIDE_FIRST, typename A, bool BY_PRODUCT>
struct VecAverage {
  using H = Half2<A>;
  using T = typename H::T;
  static constexpr int kPairs = WireVec<FMT>::kPixels / 2;
  static constexpr bool kContracts = Acc<A>::kContracts;
  T s[kPairs];
  T off, scale, rcp;
  float groups, rcp32;

  __device__ __forceinline__ VecAverage(float offset, float u8_scale, float rcp_, float groups_)
      : off(H::splat(offset)), scale(H::splat(u8_scale)), rcp(H::splat(rcp_)), groups(groups_),
        rcp32(rcp_) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) s[j] = H::splat(0.0f);
  }
  // x / G rounded once to A (bfloat16, whose host constant 1/G is float32)
  __device__ __forceinline__ T divide(T x) const {
    return H::pack(bf16_quotient<BY_PRODUCT>(__low2float(x), groups, rcp32),
                   bf16_quotient<BY_PRODUCT>(__high2float(x), groups, rcp32));
  }
  __device__ __forceinline__ void add_group(const WireVec<FMT>& c, const WireVec<FMT>& e) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const T d = vec_diff2<FMT, A>(c, e, j, off, scale);
      if constexpr (!DIVIDE_FIRST) {
        s[j] = __hadd2_rn(s[j], d);
      } else if constexpr (kContracts) {
        s[j] = __hfma2(d, rcp, s[j]);
      } else {
        s[j] = __hadd2_rn(s[j], divide(d));
      }
    }
  }
  // the vector's averages as kPairs / 4 16-byte stores
  __device__ __forceinline__ void store(A* __restrict__ plane, int64_t v) const {
    uint32_t r[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      T x = s[j];
      if constexpr (!DIVIDE_FIRST) x = kContracts ? __hmul2_rn(x, rcp) : divide(x);
      r[j] = *reinterpret_cast<const uint32_t*>(&x);
    }
    uint4* o = reinterpret_cast<uint4*>(plane) + v * (kPairs / 4);
#pragma unroll
    for (int q = 0; q < kPairs / 4; ++q)
      o[q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
};

template <int FMT, bool DIVIDE_FIRST, bool BY_PRODUCT>
struct VecAverage<FMT, DIVIDE_FIRST, float, BY_PRODUCT> {
  static constexpr int kPixels = WireVec<FMT>::kPixels;
  float s[kPixels];
  float off, scale, rcp;

  __device__ __forceinline__ VecAverage(float offset, float u8_scale, float rcp_, float)
      : off(offset), scale(u8_scale), rcp(rcp_) {
#pragma unroll
    for (int k = 0; k < kPixels; ++k) s[k] = 0.0f;
  }
  __device__ __forceinline__ void add_group(const WireVec<FMT>& c, const WireVec<FMT>& e) {
#pragma unroll
    for (int k = 0; k < kPixels; ++k)
      s[k] = fold<DIVIDE_FIRST>(s[k], vec_diff<FMT>(c, e, k, off, scale), rcp);
  }
  __device__ __forceinline__ void store(float* __restrict__ plane, int64_t v) const {
    float4* o = reinterpret_cast<float4*>(plane) + v * (kPixels / 4);
#pragma unroll
    for (int q = 0; q < kPixels / 4; ++q) {
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = DIVIDE_FIRST ? s[4 * q + k] : __fmul_rn(s[4 * q + k], rcp);
      o[q] = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
};

// Average vector v of bank-pair bp = b * pairs + p over the G groups.
template <int FMT, bool DIVIDE_FIRST, typename A, bool BY_PRODUCT>
__device__ __forceinline__ void average_vector_as(const uint8_t* __restrict__ frames,
                                                  A* __restrict__ out, int64_t bp, int64_t v,
                                                  int groups, int pairs, int64_t vectors,
                                                  int64_t plane_bytes, float offset,
                                                  float u8_scale, float rcp) {
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t group_bytes = 2 * static_cast<int64_t>(pairs) * plane_bytes;
  const uint8_t* base = frames + b * groups * group_bytes + 2 * p * plane_bytes;
  VecAverage<FMT, DIVIDE_FIRST, A, BY_PRODUCT> acc(offset, u8_scale, rcp,
                                                   static_cast<float>(groups));
  for (int g0 = 0; g0 < groups; g0 += kGroupChunk) {
    WireVec<FMT> c[kGroupChunk], e[kGroupChunk];
#pragma unroll
    for (int u = 0; u < kGroupChunk; ++u) {  // every load of the chunk before any use
      if (g0 + u < groups) {
        const uint8_t* ctl = base + (g0 + u) * group_bytes;
        c[u] = load_vec<FMT>(ctl, v);
        e[u] = load_vec<FMT>(ctl + plane_bytes, v);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroupChunk; ++u)
      if (g0 + u < groups) acc.add_group(c[u], e[u]);
  }
  acc.store(out + bp * vectors * WireVec<FMT>::kPixels, v);
}

template <int FMT, bool DIVIDE_FIRST, typename A>
__global__ void __launch_bounds__(kOneThreads)
    subtract_average_vec_kernel(const uint8_t* __restrict__ frames, A* __restrict__ out,
                                int64_t bank_pairs, int groups, int pairs, int64_t vectors,
                                int64_t plane_bytes, float offset, float u8_scale, float rcp) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kOneThreads + threadIdx.x;
  if (v >= vectors) return;
  // bfloat16 divides by the product up to G = 64: one branch a vector, not a division
  const bool by_product = !std::is_same_v<A, __nv_bfloat16> || groups <= 64;
  for (int64_t bp = blockIdx.y; bp < bank_pairs; bp += gridDim.y) {
    if (by_product) {
      average_vector_as<FMT, DIVIDE_FIRST, A, true>(frames, out, bp, v, groups, pairs, vectors,
                                                    plane_bytes, offset, u8_scale, rcp);
    } else if constexpr (std::is_same_v<A, __nv_bfloat16>) {
      average_vector_as<FMT, DIVIDE_FIRST, A, false>(frames, out, bp, v, groups, pairs, vectors,
                                                     plane_bytes, offset, u8_scale, rcp);
    }
  }
}

// The card tests' probe of bf16_quotient: out[i] = d[i] / G rounded to
// bfloat16, by bf16_quotient (rule = 1) or by a true division (rule = 0).
__global__ void bf16_quotient_kernel(const __nv_bfloat16* __restrict__ d,
                                     __nv_bfloat16* __restrict__ out, int64_t n, float groups,
                                     float rcp, bool rule) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __bfloat162float(d[i]);
  out[i] = Acc<__nv_bfloat16>::store(rule && groups <= 64.0f ? bf16_quotient<true>(x, groups, rcp)
                                                              : bf16_quotient<false>(x, groups, rcp));
}

// B2/B4 and B3/B5 with an integer sum T (scalar layout, u16 or p12 wire): the
// step folds one group in place (rows as in stream_step_kernel); the one-shot
// keeps the sum in a register across the G groups (rows as in
// subtract_average_kernel).
template <int FMT, typename T, bool DIVIDE_FIRST>
__device__ __forceinline__ void step_int_row(const uint8_t* __restrict__ frames,
                                             T* __restrict__ sum, int64_t p, int64_t h,
                                             int height, int items, int64_t row_bytes,
                                             int32_t offset, int32_t groups, bool final_div) {
  constexpr int P = Item<FMT>::kPixels;
  const uint8_t* ctl = frames + ((2 * p) * height + h) * row_bytes;
  const uint8_t* exc = ctl + height * row_bytes;
  T* out = sum + (p * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    T d[P];
    int_pair_diff_item<FMT, T>(ctl, exc, x, offset, d);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if constexpr (DIVIDE_FIRST) d[k] = IntSum<T>::div(d[k], groups);
      T s = IntSum<T>::add(out[x * P + k], d[k]);
      if constexpr (!DIVIDE_FIRST) {
        if (final_div) s = IntSum<T>::div(s, groups);
      }
      out[x * P + k] = s;
    }
  }
}

template <int FMT, typename T, bool DIVIDE_FIRST, bool TILED>
__global__ void stream_step_int_kernel(const uint8_t* __restrict__ frames,
                                       T* __restrict__ sum, int64_t pairs, int height,
                                       int items, int64_t row_bytes, int rt, int pt,
                                       int32_t offset, int32_t groups, bool final_div) {
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      step_int_row<FMT, T, DIVIDE_FIRST>(frames, sum, p, h, height, items, row_bytes, offset,
                                         groups, final_div);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    step_int_row<FMT, T, DIVIDE_FIRST>(frames, sum, p, r - p * height, height, items,
                                       row_bytes, offset, groups, final_div);
  }
}

template <int FMT, typename T, bool DIVIDE_FIRST>
__device__ __forceinline__ void average_int_row(const uint8_t* __restrict__ frames,
                                                T* __restrict__ out, int64_t bp, int64_t h,
                                                int groups, int pairs, int height, int items,
                                                int64_t row_bytes, int32_t offset) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t plane = static_cast<int64_t>(height) * row_bytes;
  const int64_t group_bytes = 2 * static_cast<int64_t>(pairs) * plane;
  const uint8_t* base = frames + b * groups * group_bytes + (2 * p) * plane + h * row_bytes;
  T* dst = out + (bp * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    T acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0;
    for (int g = 0; g < groups; ++g) {
      const uint8_t* ctl = base + g * group_bytes;
      T d[P];
      int_pair_diff_item<FMT, T>(ctl, ctl + plane, x, offset, d);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if constexpr (DIVIDE_FIRST) d[k] = IntSum<T>::div(d[k], groups);
        acc[k] = IntSum<T>::add(acc[k], d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      dst[x * P + k] = DIVIDE_FIRST ? acc[k] : IntSum<T>::div(acc[k], groups);
  }
}

template <int FMT, typename T, bool DIVIDE_FIRST, bool TILED>
__global__ void subtract_average_int_kernel(const uint8_t* __restrict__ frames,
                                            T* __restrict__ out, int64_t bank_pairs,
                                            int groups, int pairs, int height, int items,
                                            int64_t row_bytes, int rt, int pt,
                                            int32_t offset) {
  if constexpr (TILED) {
    for_tile_rows(bank_pairs, height, rt, pt, [=](int64_t bp, int64_t h) {
      average_int_row<FMT, T, DIVIDE_FIRST>(frames, out, bp, h, groups, pairs, height,
                                            items, row_bytes, offset);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t bp = r / height;
    average_int_row<FMT, T, DIVIDE_FIRST>(frames, out, bp, r - bp * height, groups, pairs,
                                          height, items, row_bytes, offset);
  }
}

// The row tiles of one launch: rt image rows of pt pairs a block, and whether
// they are a plan's (tiled) or the default layout (rt = pt = 1, one row a
// block, the untiled form of each kernel).
struct Tiles {
  int rt, pt;
  bool tiled;
  unsigned blocks(int64_t pairs, int64_t height) const {
    return static_cast<unsigned>(row_tile_blocks(pairs, height, rt, pt));
  }
};

template <int FMT, typename T>
cudaError_t launch_step_int(const void* frames, void* sum, int64_t pairs, int height,
                            int items, int64_t row_bytes, Tiles t, int32_t offset,
                            int32_t groups, bool divide_first, bool final_div,
                            cudaStream_t stream) {
  const unsigned blocks = t.blocks(pairs, height);
  const int threads = threads_for(items);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  T* s = static_cast<T*>(sum);
  return in_form(t.tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if (divide_first) {
      stream_step_int_kernel<FMT, T, true, kTiled><<<blocks, threads, 0, stream>>>(
          f, s, pairs, height, items, row_bytes, t.rt, t.pt, offset, groups, final_div);
    } else {
      stream_step_int_kernel<FMT, T, false, kTiled><<<blocks, threads, 0, stream>>>(
          f, s, pairs, height, items, row_bytes, t.rt, t.pt, offset, groups, final_div);
    }
  });
}

template <int FMT, typename T>
cudaError_t launch_oneshot_int(const void* frames, void* out, int64_t bank_pairs, int groups,
                               int pairs, int height, int items, int64_t row_bytes, Tiles t,
                               int32_t offset, bool divide_first, cudaStream_t stream) {
  const unsigned blocks = t.blocks(bank_pairs, height);
  const int threads = threads_for(items);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  T* o = static_cast<T*>(out);
  return in_form(t.tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if (divide_first) {
      subtract_average_int_kernel<FMT, T, true, kTiled><<<blocks, threads, 0, stream>>>(
          f, o, bank_pairs, groups, pairs, height, items, row_bytes, t.rt, t.pt, offset);
    } else {
      subtract_average_int_kernel<FMT, T, false, kTiled><<<blocks, threads, 0, stream>>>(
          f, o, bank_pairs, groups, pairs, height, items, row_bytes, t.rt, t.pt, offset);
    }
  });
}

// An integer sum's launch: int32 or uint16 (acc), u16 or p12 wire.
template <typename F>
cudaError_t on_int_sum(int acc, int fmt, F&& launch) {
  if (fmt != kU16 && fmt != kP12) return cudaErrorInvalidValue;
  if (acc == kAccI32) {
    return fmt == kU16 ? launch(std::integral_constant<int, kU16>{}, int32_t{})
                       : launch(std::integral_constant<int, kP12>{}, int32_t{});
  }
  if (acc == kAccU16) {
    return fmt == kU16 ? launch(std::integral_constant<int, kU16>{}, uint16_t{})
                       : launch(std::integral_constant<int, kP12>{}, uint16_t{});
  }
  return cudaErrorInvalidValue;
}

// A float accumulator's launch: float, __half or __nv_bfloat16 (acc).
template <typename F>
cudaError_t on_float_sum(int acc, F&& launch) {
  switch (acc) {
    case kAccF32: return launch(float{});
    case kAccF16: return launch(__half{});
    case kAccBF16: return launch(__nv_bfloat16{});
  }
  return cudaErrorInvalidValue;
}

// The vector path's geometry: row_tile x items pixels a block, in whole
// vectors (512 vectors when row_tile is 0), and pt pairs a block. The vector
// path takes a float sum only; a half sum (A) takes the scalar path.
template <int FMT, bool DF, typename A>
cudaError_t launch_step(const void* frames, void* sum, int64_t pairs, int height,
                        int items, int64_t row_bytes, int64_t row_tile, Tiles t, float offset,
                        float u8_scale, float rcp, float groups, bool final_div, bool vector,
                        cudaStream_t stream) {
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  A* s = static_cast<A*>(sum);
  if constexpr (FMT != kP12 && std::is_same_v<A, float>) {
    if (vector) {
      const int64_t vectors = static_cast<int64_t>(height) * items / 8;
      const int64_t share = row_tile ? (row_tile * items + 7) / 8 : kVecPerBlock;
      const int64_t pair_blocks = (pairs + t.pt - 1) / t.pt;
      const dim3 grid(static_cast<unsigned>((vectors + share - 1) / share),
                      static_cast<unsigned>(pair_blocks < 65535 ? pair_blocks : 65535));
      return in_form(t.tiled, [&](auto form) {
        stream_step_vec_kernel<FMT, DF, decltype(form)::value><<<grid, kVecThreads, 0, stream>>>(
            f, s, pairs, vectors, share, t.pt, height * row_bytes, offset, u8_scale, rcp,
            final_div);
      });
    }
  }
  return in_form(t.tiled, [&](auto form) {
    stream_step_kernel<FMT, DF, decltype(form)::value, A>
        <<<t.blocks(pairs, height), threads_for(items), 0, stream>>>(
            f, s, pairs, height, items, row_bytes, t.rt, t.pt, offset, u8_scale, rcp, groups,
            final_div);
  });
}

// Alignment (bytes) of a plane start that the vector path's loads need.
int vector_align(int fmt) { return fmt == kU16 ? 16 : 8; }

// The vector path's one geometry (256 vectors a block, every bank-pair), or
// the scalar layout's rows in the plan's tiles t.
template <int FMT, bool DF, typename A>
cudaError_t launch_oneshot(const void* frames, void* out, int64_t bank_pairs,
                           int groups, int pairs, int height, int items,
                           int64_t row_bytes, Tiles t, float offset,
                           float u8_scale, float rcp, bool vector, cudaStream_t stream) {
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  A* o = static_cast<A*>(out);
  if (vector) {
    const int64_t vectors = static_cast<int64_t>(height) * items * Item<FMT>::kPixels /
                            WireVec<FMT>::kPixels;
    const dim3 grid(static_cast<unsigned>((vectors + kOneThreads - 1) / kOneThreads),
                    static_cast<unsigned>(bank_pairs < 65535 ? bank_pairs : 65535));
    subtract_average_vec_kernel<FMT, DF, A><<<grid, kOneThreads, 0, stream>>>(
        f, o, bank_pairs, groups, pairs, vectors, height * row_bytes, offset, u8_scale, rcp);
    return cudaGetLastError();
  }
  return in_form(t.tiled, [&](auto form) {
    subtract_average_kernel<FMT, DF, decltype(form)::value, A>
        <<<t.blocks(bank_pairs, height), threads_for(items), 0, stream>>>(
            f, o, bank_pairs, groups, pairs, height, items, row_bytes, t.rt, t.pt, offset,
            u8_scale, rcp);
  });
}

// Validate a launch's row tiles (0 = the default, 1) for `pairs` x `height`
// rows; false when the grid cannot hold them.
bool tiles_for(int64_t pairs, int64_t height, int64_t row_tile, int64_t pair_tile, Tiles* t) {
  if (row_tile < 0 || pair_tile < 0) return false;
  const int64_t rt = row_tile ? row_tile : 1, pt = pair_tile ? pair_tile : 1;
  if (!row_tiles_ok(pairs, height, rt, pt)) return false;
  *t = Tiles{static_cast<int>(rt), static_cast<int>(pt), row_tile != 0 || pair_tile != 0};
  return true;
}

bool integer_acc(int acc) { return acc == kAccI32 || acc == kAccU16; }

int step(const void* frames, void* sum, int64_t pairs, int64_t height,
         int64_t items, int64_t row_bytes, int fmt, int divide_first,
         int final_div, int vector, float offset, float u8_scale, float rcp,
         int acc, int64_t groups, int64_t row_tile, int64_t pair_tile, void* stream) {
  const int64_t rows = pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff) return cudaErrorInvalidValue;
  if (fmt < kU16 || fmt > kP12) return cudaErrorInvalidValue;
  if (groups < 1 || groups > 0x7fffffff) return cudaErrorInvalidValue;
  Tiles t;
  if (!tiles_for(pairs, height, row_tile, pair_tile, &t)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  if (integer_acc(acc)) {  // integer sums: u16 or p12 wire, the scalar layout only
    if (vector) return cudaErrorInvalidValue;
    const int32_t off = static_cast<int32_t>(offset), g = static_cast<int32_t>(groups);
    return on_int_sum(acc, fmt, [&](auto f, auto zero) {
      return launch_step_int<decltype(f)::value, decltype(zero)>(
          frames, sum, pairs, h, it, row_bytes, t, off, g, divide_first, final_div, s);
    });
  }
  // the host chose the vector path; a shape it cannot take is refused, never rerouted
  if (vector && (fmt == kP12 || acc != kAccF32 || (height * items) % 8 ||
                 reinterpret_cast<uintptr_t>(frames) % vector_align(fmt) ||
                 reinterpret_cast<uintptr_t>(sum) % 16))
    return cudaErrorMisalignedAddress;
  const bool fd = final_div != 0, vec = vector != 0;
  const float gf = static_cast<float>(groups);
  return on_float_sum(acc, [&](auto zero) {
    using A = decltype(zero);
#define STEP(F, D) \
  launch_step<F, D, A>(frames, sum, pairs, h, it, row_bytes, row_tile, t, offset, u8_scale, rcp, \
                       gf, fd, vec, s)
    switch (fmt) {
      case kU16: return divide_first ? STEP(kU16, true) : STEP(kU16, false);
      case kU8: return divide_first ? STEP(kU8, true) : STEP(kU8, false);
      case kP12: return divide_first ? STEP(kP12, true) : STEP(kP12, false);
    }
#undef STEP
    return cudaErrorInvalidValue;
  });
}

int oneshot(const void* frames, void* out, int64_t banks, int64_t groups,
            int64_t pairs, int64_t height, int64_t items, int64_t row_bytes,
            int fmt, int divide_first, int vector, float offset, float u8_scale, float rcp,
            int acc, int64_t row_tile, int64_t pair_tile, void* stream) {
  const int64_t rows = banks * pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff || groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (fmt < kU16 || fmt > kP12) return cudaErrorInvalidValue;
  Tiles t;
  if (!tiles_for(banks * pairs, height, row_tile, pair_tile, &t)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups), p = static_cast<int>(pairs);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  const int64_t bp = banks * pairs;
  // the host chose the vector path; a shape it cannot take is refused, never rerouted
  const int64_t plane_px = height * items * (fmt == kP12 ? 2 : 1);
  if (vector && (integer_acc(acc) || !wire_vectors_ok(fmt, plane_px, frames, out)))
    return cudaErrorInvalidValue;
  if (integer_acc(acc)) {  // integer sums: u16 or p12 wire, the scalar layout only
    if (groups < 1) return cudaErrorInvalidValue;
    const int32_t off = static_cast<int32_t>(offset);
    return on_int_sum(acc, fmt, [&](auto f, auto zero) {
      return launch_oneshot_int<decltype(f)::value, decltype(zero)>(
          frames, out, bp, g, p, h, it, row_bytes, t, off, divide_first, s);
    });
  }
  const bool vec = vector != 0;
  return on_float_sum(acc, [&](auto zero) {
    using A = decltype(zero);
#define ONESHOT(F, D) \
  launch_oneshot<F, D, A>(frames, out, bp, g, p, h, it, row_bytes, t, offset, u8_scale, rcp, vec, s)
    switch (fmt) {
      case kU16: return divide_first ? ONESHOT(kU16, true) : ONESHOT(kU16, false);
      case kU8: return divide_first ? ONESHOT(kU8, true) : ONESHOT(kU8, false);
      case kP12: return divide_first ? ONESHOT(kP12, true) : ONESHOT(kP12, false);
    }
#undef ONESHOT
    return cudaErrorInvalidValue;
  });
}

}  // namespace

// Plain C entry points, one per TPU kernel, loaded with ctypes. Each returns
// the cudaError_t of its launch (0 = launched). `items` is the number of
// thread items per output row: W, or W/2 for p12. `row_bytes` is the wire
// row length in bytes. `row_tile` and `pair_tile` (0 = the default geometry)
// set the image rows and pairs a block covers: on the step's vector path a
// block's share is row_tile x W pixels in whole vectors (512 vectors by
// default), and the one-shot's vector path takes none; a launch the grid
// cannot hold returns cudaErrorInvalidValue. The `vector` flag selects the vector path; the host
// sets it only where the planes allow it (denoise_stream.step_path,
// oneshot_path), and a launch that asks for it on planes that do not returns
// cudaErrorMisalignedAddress (a step) or cudaErrorInvalidValue (a one-shot).
// `acc` is the sum's AccumCode (quant.cuh): an integer sum takes u16 or p12
// wire and the scalar layout (else cudaErrorInvalidValue), and a step's
// `groups` is G.
extern "C" {

int alg3_stream_step_launch(const void* frames, void* sum, int64_t pairs,
                            int64_t height, int64_t items, int64_t row_bytes,
                            int fmt, int divide_first, int final_div,
                            int vector, float offset, float u8_scale, float rcp,
                            int acc, int64_t groups, int64_t row_tile, int64_t pair_tile,
                            void* stream) {
  return step(frames, sum, pairs, height, items, row_bytes, fmt, divide_first,
              final_div, vector, offset, u8_scale, rcp, acc, groups, row_tile, pair_tile,
              stream);
}

int multibank_stream_step_launch(const void* frames, void* sum, int64_t banks,
                                 int64_t pairs, int64_t height, int64_t items,
                                 int64_t row_bytes, int fmt, int divide_first,
                                 int final_div, int vector, float offset,
                                 float u8_scale, float rcp, int acc, int64_t groups,
                                 int64_t row_tile, int64_t pair_tile, void* stream) {
  return step(frames, sum, banks * pairs, height, items, row_bytes, fmt,
              divide_first, final_div, vector, offset, u8_scale, rcp, acc, groups,
              row_tile, pair_tile, stream);
}

int alg3_subtract_average_launch(const void* frames, void* out, int64_t groups,
                                 int64_t pairs, int64_t height, int64_t items,
                                 int64_t row_bytes, int fmt, int divide_first, int vector,
                                 float offset, float u8_scale, float rcp, int acc,
                                 int64_t row_tile, int64_t pair_tile, void* stream) {
  return oneshot(frames, out, 1, groups, pairs, height, items, row_bytes, fmt,
                 divide_first, vector, offset, u8_scale, rcp, acc, row_tile, pair_tile, stream);
}

int multibank_subtract_average_launch(const void* frames, void* out,
                                      int64_t banks, int64_t groups,
                                      int64_t pairs, int64_t height,
                                      int64_t items, int64_t row_bytes,
                                      int fmt, int divide_first, int vector, float offset,
                                      float u8_scale, float rcp, int acc,
                                      int64_t row_tile, int64_t pair_tile, void* stream) {
  return oneshot(frames, out, banks, groups, pairs, height, items, row_bytes,
                 fmt, divide_first, vector, offset, u8_scale, rcp, acc, row_tile, pair_tile,
                 stream);
}

// The bf16_quotient probe over n bfloat16 values (tests only; not a kernel of
// the denoising path). rcp is f32(1/G).
int bf16_quotient_launch(const void* d, void* out, int64_t n, float groups, float rcp, int rule,
                         void* stream) {
  if (n <= 0) return cudaSuccess;
  bf16_quotient_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(d), static_cast<__nv_bfloat16*>(out), n, groups, rcp,
      rule != 0);
  return cudaGetLastError();
}

}  // extern "C"
