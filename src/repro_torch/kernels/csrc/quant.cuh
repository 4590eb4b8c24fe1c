// B1: the shared dequantization prologue of every ingest kernel.
//
// Replaces src/repro/kernels/quant.py pair_diff_block, which the JAX package
// runs inside each Pallas ingest kernel. Here it is a __device__ function
// that the ingest kernels (denoise_stream.cu, denoise_median.cu,
// denoise_ema.cu) inline, so a wire byte is read once, in the kernel that
// uses it. pair_diff reads one thread item (one pixel, or two for p12);
// pair_diff8 and its loaders, below it, read eight pixels with vector loads
// and round exactly as pair_diff does; vec_diff and vec_diff2 do the same on
// the wider vectors of the one-shot's and the insert's vector paths.
//
// Rounding is part of the contract: the reference's jitted prologue computes
// the u8 dequant as fma(e, S, -(c*S)) + offset. It is written here with _rn
// intrinsics, which nvcc never contracts or reorders, so the default
// -fmad=true cannot change a result. pair_diff_acc is the same prologue for
// a float16 or bfloat16 accumulator (Acc, below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_quant {

enum WireFormat : int { kU16 = 0, kU8 = 1, kP12 = 2 };

// Accumulator types: float, __half, __nv_bfloat16. Values travel between
// operations as float, each rounded to the accumulator's type where the
// reference's compiled kernel rounds (repro_torch/kernels/ref.py):
//   * float32 as it always was;
//   * float16 keeps the float32 rules in float16: every operation rounded to
//     float16, x / G as x * f16(1/G), a contracted a * b + c one float16 FMA
//     (__hfma, rounded once);
//   * bfloat16 rounds every operation and contracts nothing: no FMA, and
//     x / G a true division.
// One operation on two half values computed in float and rounded once is the
// correctly rounded half result, so round(__fadd_rn(a, b)) is the half add.
// The host passes every constant (offset, u8 scale, 1/G) already rounded to
// the accumulator's type.
template <typename A>
struct Acc;
template <>
struct Acc<float> {
  static constexpr bool kContracts = true;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};
template <>
struct Acc<__half> {
  static constexpr bool kContracts = true;
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half store(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  // a, b and c are float16 values: the exact a * b + c rounded once
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __half2float(__hfma(__float2half_rn(a), __float2half_rn(b), __float2half_rn(c)));
  }
};
// bfloat16 rounds through the packed conversion (cvt.rn.bf16x2.f32, SASS
// F2FP): the same round to nearest even as cvt.rn.bf16.f32, which sm_90
// runs as F2F at a quarter of F2FP's rate, and which set the pace of B8 and
// B9 in bfloat16 (PERF.md section 6).
template <>
struct Acc<__nv_bfloat16> {
  static constexpr bool kContracts = false;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __low2bfloat16(__float2bfloat162_rn(x));
  }
  static __device__ __forceinline__ float round(float x) {
    return __low2float(__float2bfloat162_rn(x));
  }
};

// The arithmetic of accumulator A on float-held values of type A.
template <typename A>
__device__ __forceinline__ float acc_add(float a, float b) {
  return Acc<A>::round(__fadd_rn(a, b));
}
template <typename A>
__device__ __forceinline__ float acc_sub(float a, float b) {
  return Acc<A>::round(__fsub_rn(a, b));
}
template <typename A>
__device__ __forceinline__ float acc_mul(float a, float b) {
  return Acc<A>::round(__fmul_rn(a, b));
}
template <typename A>
__device__ __forceinline__ float acc_div(float a, float b) {
  return Acc<A>::round(__fdiv_rn(a, b));
}

// The running-sum fold s + d (divide-last) or s + d / G (divide-first): an
// FMA with the host's rounded 1/G where A contracts, else a true division.
template <typename A, bool DIVIDE_FIRST>
__device__ __forceinline__ float acc_fold(float s, float d, float rcp, float groups) {
  if constexpr (!DIVIDE_FIRST) {
    return acc_add<A>(s, d);
  } else if constexpr (Acc<A>::kContracts) {
    return Acc<A>::fma(d, rcp, s);
  } else {
    return acc_add<A>(s, acc_div<A>(d, groups));
  }
}

// x / G: x * (1/G) where A contracts, else a true division.
template <typename A>
__device__ __forceinline__ float acc_scale(float x, float rcp, float groups) {
  if constexpr (Acc<A>::kContracts) return acc_mul<A>(x, rcp);
  return acc_div<A>(x, groups);
}

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

// The wire value of pixel k (0 or 1) of item x, exactly as a float.
template <int FMT>
__device__ __forceinline__ void wire_pixels(const uint8_t* __restrict__ row, int x,
                                            float v[Item<FMT>::kPixels]) {
  if constexpr (FMT == kU16) {
    v[0] = static_cast<float>(reinterpret_cast<const uint16_t*>(row)[x]);
  } else if constexpr (FMT == kU8) {
    v[0] = static_cast<float>(row[x]);
  } else {
    const uint8_t* b = row + 3 * x;
    const int b0 = b[0], b1 = b[1], b2 = b[2];
    v[0] = static_cast<float>(b0 | ((b1 & 0xF) << 8));
    v[1] = static_cast<float>((b1 >> 4) | (b2 << 4));
  }
}

// pair_diff for a half accumulator A: exc - ctl + offset rounded as the
// reference rounds it in A. `wide` gets the last add unrounded: XLA computes
// the last operation of a bfloat16 value that a float32 sum reads in float32
// (denoise_ema.cu), so the EMA kernel's chunk mean sums `wide`.
template <int FMT, typename A>
__device__ __forceinline__ void pair_diff_acc(const uint8_t* __restrict__ ctl,
                                              const uint8_t* __restrict__ exc, int x,
                                              float offset, float u8_scale,
                                              float d[Item<FMT>::kPixels],
                                              float wide[Item<FMT>::kPixels]) {
  constexpr int P = Item<FMT>::kPixels;
  float c[P], e[P];
  wire_pixels<FMT>(ctl, x, c);
  wire_pixels<FMT>(exc, x, e);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float pre;
    if constexpr (FMT == kU8) {
      if constexpr (Acc<A>::kContracts) {
        pre = Acc<A>::fma(e[k], u8_scale, -acc_mul<A>(c[k], u8_scale));
      } else {
        pre = acc_sub<A>(acc_mul<A>(e[k], u8_scale), acc_mul<A>(c[k], u8_scale));
      }
    } else {
      pre = acc_sub<A>(Acc<A>::round(e[k]), Acc<A>::round(c[k]));
    }
    wide[k] = __fadd_rn(pre, offset);
    d[k] = Acc<A>::round(wide[k]);
  }
}

// pair_diff for accumulator A: the float one above, or pair_diff_acc.
template <int FMT, typename A>
__device__ __forceinline__ void pair_diff_as(const uint8_t* __restrict__ ctl,
                                             const uint8_t* __restrict__ exc, int x,
                                             float offset, float u8_scale,
                                             float d[Item<FMT>::kPixels]) {
  if constexpr (std::is_same_v<A, float>) {
    pair_diff<FMT>(ctl, exc, x, offset, u8_scale, d);
  } else {
    float wide[Item<FMT>::kPixels];
    pair_diff_acc<FMT, A>(ctl, exc, x, offset, u8_scale, d, wide);
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

// Vector helpers of the one-shot kernels' vector path (denoise_stream.cu): a
// thread's run of kPixels consecutive pixels of one wire plane, in wide loads.
//   u16: 8 pixels, one 16-byte load;  u8: 16 pixels, one 16-byte load;
//   p12: 16 pixels (8 three-byte items), 24 bytes in three 8-byte loads.
// Vector v of a plane starts at byte v * kBytes, so a plane whose start is
// aligned to kAlign has every vector aligned for its loads.
template <int FMT>
struct WireVec;
template <>
struct WireVec<kU16> {
  static constexpr int kPixels = 8, kBytes = 16, kAlign = 16;
  uint32_t w[4];
};
template <>
struct WireVec<kU8> {
  static constexpr int kPixels = 16, kBytes = 16, kAlign = 16;
  uint32_t w[4];
};
template <>
struct WireVec<kP12> {
  static constexpr int kPixels = 16, kBytes = 24, kAlign = 8;
  uint32_t w[6];
};

template <int FMT>
__device__ __forceinline__ WireVec<FMT> load_vec(const uint8_t* __restrict__ plane, int64_t v) {
  WireVec<FMT> x;
  if constexpr (FMT == kP12) {
    const uint2* q = reinterpret_cast<const uint2*>(plane) + 3 * v;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint2 a = q[i];
      x.w[2 * i] = a.x;
      x.w[2 * i + 1] = a.y;
    }
  } else {
    const uint4 a = reinterpret_cast<const uint4*>(plane)[v];
    x.w[0] = a.x, x.w[1] = a.y, x.w[2] = a.z, x.w[3] = a.w;
  }
  return x;
}

// The wire value of pixel k of a loaded vector (k a compile-time index once
// unrolled). A p12 item j sits at bytes 3j..3j+2 of the vector: one funnel
// shift brings its 24 bits down, low pixel in bits 0-11, high in 12-23.
template <int FMT>
__device__ __forceinline__ uint32_t wire_value(const WireVec<FMT>& x, int k) {
  if constexpr (FMT == kU16) {
    return (k & 1) ? x.w[k >> 1] >> 16 : x.w[k >> 1] & 0xFFFFu;
  } else if constexpr (FMT == kU8) {
    return (x.w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
  } else {
    const int byte = 3 * (k >> 1), i = byte >> 2, shift = 8 * (byte & 3);
    const uint32_t t = shift <= 8 ? x.w[i] >> shift : __funnelshift_r(x.w[i], x.w[i + 1], shift);
    return (k & 1) ? (t >> 12) & 0xFFFu : t & 0xFFFu;
  }
}

// An integer below 2^23 as a float, exactly: its bits under the exponent of
// 2^23, less 2^23 (two full-rate operations instead of a quarter-rate I2F).
__device__ __forceinline__ float exact_float(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | x), 8388608.0f);
}

// Pairs of a half type: __half2 or __nv_bfloat162, for the vector path's
// packed arithmetic. The _rn operations are each correctly rounded and never
// contracted, so each gives the bits of Acc<A>'s float operation rounded
// once (see Acc above); pack rounds two floats in one packed conversion.
template <typename A>
struct Half2;
template <>
struct Half2<__half> {
  using T = __half2;
  static __device__ __forceinline__ T pack(float lo, float hi) { return __floats2half2_rn(lo, hi); }
  static __device__ __forceinline__ T splat(float x) { return __float2half2_rn(x); }
};
template <>
struct Half2<__nv_bfloat16> {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T pack(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ T splat(float x) { return __float2bfloat162_rn(x); }
};

// The one pair difference of the vector paths (B3/B5's one-shot and B6's
// insert): exc - ctl + offset of the pixels of a wire vector pair, rounded as
// pair_diff_as rounds it. float32 (vec_diff): pixel k as pair_diff computes
// it. A half type A (vec_diff2): pixels 2j and 2j + 1 in A's packed
// arithmetic, one correctly rounded operation where pair_diff_acc rounds a
// float one to A: u8 into float16 is one __hfma2 of fma(e, S, -(c*S)), as XLA
// contracts it; bfloat16 contracts nothing; a u16 value is rounded to A in the
// packed conversion. `off` and `scale` are the host's offset and u8 scale,
// already rounded to the sum's type.
template <int FMT>
__device__ __forceinline__ float vec_diff(const WireVec<FMT>& c, const WireVec<FMT>& e, int k,
                                          float off, float scale) {
  const float fc = exact_float(wire_value<FMT>(c, k));
  const float fe = exact_float(wire_value<FMT>(e, k));
  return FMT == kU8 ? __fadd_rn(__fmaf_rn(fe, scale, -__fmul_rn(fc, scale)), off)
                    : __fadd_rn(__fsub_rn(fe, fc), off);
}

// pixels 2j and 2j + 1 of a wire vector, each rounded to A (exact for u8)
template <int FMT, typename A>
__device__ __forceinline__ typename Half2<A>::T wire_pair(const WireVec<FMT>& x, int j) {
  return Half2<A>::pack(exact_float(wire_value<FMT>(x, 2 * j)),
                        exact_float(wire_value<FMT>(x, 2 * j + 1)));
}

template <int FMT, typename A>
__device__ __forceinline__ typename Half2<A>::T vec_diff2(const WireVec<FMT>& c,
                                                          const WireVec<FMT>& e, int j,
                                                          typename Half2<A>::T off,
                                                          typename Half2<A>::T scale) {
  using T = typename Half2<A>::T;
  const T c2 = wire_pair<FMT, A>(c, j), e2 = wire_pair<FMT, A>(e, j);
  T pre;
  if constexpr (FMT == kU8 && Acc<A>::kContracts) {  // fma(e, S, -(c*S)), one float16 FMA
    pre = __hfma2(e2, scale, __hneg2(__hmul2_rn(c2, scale)));
  } else if constexpr (FMT == kU8) {  // bfloat16: each operation rounded
    pre = __hsub2_rn(__hmul2_rn(e2, scale), __hmul2_rn(c2, scale));
  } else {
    pre = __hsub2_rn(e2, c2);
  }
  return __hadd2_rn(pre, off);
}

// Whether the vector paths' loads and stores can take planes of plane_px
// pixels at these pointers: plane_px a multiple of the vector, the frames
// aligned for its loads (WireVec kAlign) and the output on 16 bytes; every
// plane then starts so aligned (the host's denoise_stream.oneshot_path and
// denoise_median.insert_path rule).
inline bool wire_vectors_ok(int fmt, int64_t plane_px, const void* frames, const void* out) {
  const auto ok = [&](auto vec) {
    using V = decltype(vec);
    return plane_px % V::kPixels == 0 && reinterpret_cast<uintptr_t>(frames) % V::kAlign == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  };
  switch (fmt) {
    case kU16: return ok(WireVec<kU16>{});
    case kU8: return ok(WireVec<kU8>{});
    case kP12: return ok(WireVec<kP12>{});
  }
  return false;
}

// x / G rounded once to bfloat16, for a bfloat16 x (a pair difference, or a
// sum): for G <= 64 (BY_PRODUCT) the product x * f32(1/G), which rounds to
// the bfloat16 of the true division for every one of the 65,536 bfloat16 x,
// else the true division. (x has 8 significant bits, so x / G is never a
// bfloat16 midpoint: G * m for a midpoint m needs 9 or more; and it lies at
// least 2^-9 / G of x from every midpoint, far beyond the product's 2^-23.
// The card tests hold every x and G = 1..64 against __fdiv_rn through
// bf16_quotient_launch, denoise_stream.cu.) The one-shots' vector path
// (denoise_stream.cu) and B10's pass B (denoise_tmpframe.cu) divide by it.
template <bool BY_PRODUCT>
__device__ __forceinline__ float bf16_quotient(float x, float groups, float rcp) {
  return BY_PRODUCT ? __fmul_rn(x, rcp) : __fdiv_rn(x, groups);
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

// The same for thread item x of a u16 or p12 wire row pair: one pixel, or
// the two 12-bit pixels of a p12 item.
template <int FMT, typename T>
__device__ __forceinline__ void int_pair_diff_item(const uint8_t* __restrict__ ctl,
                                                   const uint8_t* __restrict__ exc, int x,
                                                   int32_t offset,
                                                   T d[Item<FMT>::kPixels]) {
  static_assert(FMT != kU8, "u8 wire has no integer sum");
  if constexpr (FMT == kU16) {
    d[0] = int_pair_diff<T>(reinterpret_cast<const uint16_t*>(ctl)[x],
                            reinterpret_cast<const uint16_t*>(exc)[x], offset);
  } else {
    const uint8_t* cp = ctl + 3 * x;
    const uint8_t* ep = exc + 3 * x;
    const uint32_t c0 = cp[0], c1 = cp[1], c2 = cp[2];
    const uint32_t e0 = ep[0], e1 = ep[1], e2 = ep[2];
    d[0] = int_pair_diff<T>(static_cast<uint16_t>(c0 | ((c1 & 0xF) << 8)),
                            static_cast<uint16_t>(e0 | ((e1 & 0xF) << 8)), offset);
    d[1] = int_pair_diff<T>(static_cast<uint16_t>((c1 >> 4) | (c2 << 4)),
                            static_cast<uint16_t>((e1 >> 4) | (e2 << 4)), offset);
  }
}

// Accumulator codes of the C entry points.
enum AccumCode : int { kAccF32 = 0, kAccI32 = 1, kAccU16 = 2, kAccF16 = 3, kAccBF16 = 4 };

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
