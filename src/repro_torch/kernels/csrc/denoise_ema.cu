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
// The design below is the float32 kernel's. A float16 or bfloat16 state
// takes ema_half_kernel, at the end of this file: one thread a pixel, the
// chunks in order, rounded as XLA rounds the reference's kernel in that type.
//
// Design: chunk-parallel statistics, ordered merge. The order of rounding
// (below) fixes the order within a chunk and the order of the merges, not
// which thread does what: each chunk's sum, centred sum of squares and EMA
// updates depend on no other chunk, and only the merge (about ten operations
// per chunk and pixel) runs in sequence. So a block owns a tile of 32
// consecutive thread items of the (H * W) plane (pixels; pixel pairs for
// p12) and has 8 chunk lanes of one warp each: 256 threads. In each round
// chunk lane r takes chunk c = 8 * round + r. It issues every wire and ema
// load of the chunk's pairs before it uses one, updates the EMA in place,
// forms the chunk's sum and centred sum of squares, and writes both to
// shared memory with the chunk's merge weights. A chunk of up to kCap pairs
// keeps its diffs in registers, in a kernel compiled for its exact pair
// count; a longer one re-reads its wire pairs through L1, as the
// one-thread-per-pixel design did. After one barrier, warp 0 folds the
// round's chunks into mean/M2 in chunk order while the other warps start
// the next round's loads: the stats are double-buffered, so one barrier per
// round suffices. Shared memory per block is 2 x 8 x 32 x 8 bytes (twice
// that for p12) for any chunk count.
//
// At the paper's shape (20,480 pixels, 100 chunks of 5 pairs) that is 640
// blocks in 13 rounds. The registers are held to 48 a thread (kMinBlocks)
// so that all 640 blocks are resident at once, 39 warps per SM, each warp
// with five pairs of loads (1.25 KB) in flight per round: at 55 registers
// only 528 fitted, the other 112 waited for a second wave, and the kernel
// took twice as long on the H100.
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
// 1/m already rounded to float32. That is the order up to kChainMax pairs a
// chunk. Longer chunks take XLA's CPU orders for the two sums (the plain
// version's chunk_sums in kernels/denoise_ema.py says why):
//   up to kLanesMax: 8 lanes, lane l summing (or fma-chaining the squares
//     of) pairs l, l + 8, ... below 8 * (m / 8); the lanes folded l + l+4,
//     then + 2, then + 1; the remaining pairs chained on in order;
//   above: windows of kWindow pairs over the chunk padded with zeros to a
//     multiple of kWindow (low pad (padded - m) / 2), each summed in order,
//     then the partials in order; the centred value is fma(-s, 1/m, d), its
//     square rounded on its own, and the merge's cm - mean is
//     fma(s, 1/m, -mean).

#include "quant.cuh"

namespace {

using namespace repro_quant;

constexpr int kLanes = 32;      // thread items per block, one per thread of a warp
constexpr int kChunkLanes = 8;  // chunks per round, one warp each
constexpr int kCap = 8;         // chunks of up to kCap pairs keep their diffs in registers
constexpr int kChainMax = 24;   // the sums' order by chunk length (see above)
constexpr int kLanesMax = 32;
constexpr int kWindow = 32;

// Blocks per SM the registers must allow: 5 hold the paper's 640 tiles of 32
// pixels (u16, u8) on 132 SMs at once; p12 has half as many tiles. A tile
// that waits for a second wave doubles the kernel's time.
template <int FMT>
constexpr int kMinBlocks = FMT == kP12 ? 3 : 5;

// The 8-lane vector loop's fold: lanes l + l+4, then + 2, then + 1.
template <int P>
__device__ __forceinline__ void fold_lanes(float (&lane)[8][P], float (&out)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float a0 = __fadd_rn(lane[0][k], lane[4][k]), a1 = __fadd_rn(lane[1][k], lane[5][k]);
    const float a2 = __fadd_rn(lane[2][k], lane[6][k]), a3 = __fadd_rn(lane[3][k], lane[7][k]);
    out[k] = __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
  }
}

// A chunk longer than kCap pairs (TILE 0) at thread item t, s and sq zeroed:
// the first pass updates the EMA and forms s, the second re-reads the wire
// pairs for the centred squares, each pass in the chunk length's order.
template <int FMT>
__device__ __forceinline__ void chunk_stats_long(
    float* __restrict__ ema_px, const uint8_t* __restrict__ ctl0, int t, int tile,
    int64_t frame_bytes, int64_t plane_px, float offset, float u8_scale, float alpha,
    float one_minus_alpha, float rcp_tile, float (&s)[Item<FMT>::kPixels],
    float (&sq)[Item<FMT>::kPixels]) {
  constexpr int P = Item<FMT>::kPixels;
  auto diff = [&](int i, float (&d)[P]) {
    const uint8_t* ctl = ctl0 + 2 * i * frame_bytes;
    pair_diff<FMT>(ctl, ctl + frame_bytes, t, offset, u8_scale, d);
  };
  auto ema_diff = [&](int i, float (&d)[P]) {
    diff(i, d);
    float* e = ema_px + i * plane_px;
#pragma unroll
    for (int k = 0; k < P; ++k) e[k] = __fmaf_rn(e[k], one_minus_alpha, __fmul_rn(alpha, d[k]));
  };
  if (tile <= kChainMax) {
    for (int i = 0; i < tile; ++i) {
      float d[P];
      ema_diff(i, d);
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = __fadd_rn(s[k], d[k]);
    }
    for (int i = 0; i < tile; ++i) {
      float d[P];
      diff(i, d);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dc = __fsub_rn(d[k], __fmul_rn(s[k], rcp_tile));
        sq[k] = __fmaf_rn(dc, dc, sq[k]);
      }
    }
    return;
  }
  if (tile <= kLanesMax) {
    const int full = tile / 8 * 8;
    float lane[8][P];
#pragma unroll
    for (int l = 0; l < 8; ++l)
#pragma unroll
      for (int k = 0; k < P; ++k) lane[l][k] = 0.0f;
    for (int i0 = 0; i0 < full; i0 += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float d[P];
        ema_diff(i0 + l, d);
#pragma unroll
        for (int k = 0; k < P; ++k) lane[l][k] = __fadd_rn(lane[l][k], d[k]);
      }
    }
    fold_lanes<P>(lane, s);
    for (int i = full; i < tile; ++i) {
      float d[P];
      ema_diff(i, d);
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = __fadd_rn(s[k], d[k]);
    }
    float cm[P];
#pragma unroll
    for (int k = 0; k < P; ++k) cm[k] = __fmul_rn(s[k], rcp_tile);
#pragma unroll
    for (int l = 0; l < 8; ++l)
#pragma unroll
      for (int k = 0; k < P; ++k) lane[l][k] = 0.0f;
    for (int i0 = 0; i0 < full; i0 += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float d[P];
        diff(i0 + l, d);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float dc = __fsub_rn(d[k], cm[k]);
          lane[l][k] = __fmaf_rn(dc, dc, lane[l][k]);
        }
      }
    }
    fold_lanes<P>(lane, sq);
    for (int i = full; i < tile; ++i) {
      float d[P];
      diff(i, d);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dc = __fsub_rn(d[k], cm[k]);
        sq[k] = __fmaf_rn(dc, dc, sq[k]);
      }
    }
    return;
  }
  const int padded = (tile + kWindow - 1) / kWindow * kWindow;
  const int low = (padded - tile) / 2;
  float part[P];
#pragma unroll
  for (int k = 0; k < P; ++k) part[k] = 0.0f;
  for (int i = 0; i < tile; ++i) {
    if (i > 0 && (i + low) % kWindow == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        s[k] = __fadd_rn(s[k], part[k]);
        part[k] = 0.0f;
      }
    }
    float d[P];
    ema_diff(i, d);
#pragma unroll
    for (int k = 0; k < P; ++k) part[k] = __fadd_rn(part[k], d[k]);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    s[k] = __fadd_rn(s[k], part[k]);
    part[k] = 0.0f;
  }
  for (int i = 0; i < tile; ++i) {
    if (i > 0 && (i + low) % kWindow == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        sq[k] = __fadd_rn(sq[k], part[k]);
        part[k] = 0.0f;
      }
    }
    float d[P];
    diff(i, d);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dc = __fmaf_rn(-s[k], rcp_tile, d[k]);
      part[k] = __fadd_rn(part[k], __fmul_rn(dc, dc));
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) sq[k] = __fadd_rn(sq[k], part[k]);
}

// One chunk of pairs [p0, p0 + tile) at thread item t: update the EMA in
// place and return the chunk's sequential sum s and centred sum of squares
// sq, rounded as the contract says. The wire frame of pair p is 2p (control)
// and 2p + 1 (excitation); every plane is (H * W) contiguous pixels. TILE is
// the chunk's pair count when it is at most kCap (its diffs stay in
// registers), and 0 for a longer chunk (its wire pairs are read twice, and
// its sums take the order of its length).
template <int FMT, int TILE>
__device__ __forceinline__ void chunk_stats(
    const uint8_t* __restrict__ frames, float* __restrict__ ema, int t, int64_t p0,
    int tile, int64_t frame_bytes, int64_t plane_px, float offset, float u8_scale,
    float alpha, float one_minus_alpha, float rcp_tile, float (&s)[Item<FMT>::kPixels],
    float (&sq)[Item<FMT>::kPixels]) {
  constexpr int P = Item<FMT>::kPixels;
  float* ema_px = ema + p0 * plane_px + static_cast<int64_t>(t) * P;
  const uint8_t* ctl0 = frames + 2 * p0 * frame_bytes;
#pragma unroll
  for (int k = 0; k < P; ++k) s[k] = sq[k] = 0.0f;
  if constexpr (TILE > 0) {
    float d[TILE][P], e[TILE][P];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {  // every load of the chunk before any use
      const uint8_t* ctl = ctl0 + 2 * i * frame_bytes;
      pair_diff<FMT>(ctl, ctl + frame_bytes, t, offset, u8_scale, d[i]);
#pragma unroll
      for (int k = 0; k < P; ++k) e[i][k] = ema_px[i * plane_px + k];
    }
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        ema_px[i * plane_px + k] = __fmaf_rn(e[i][k], one_minus_alpha, __fmul_rn(alpha, d[i][k]));
        s[k] = __fadd_rn(s[k], d[i][k]);
      }
    }
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dc = __fsub_rn(d[i][k], __fmul_rn(s[k], rcp_tile));
        sq[k] = __fmaf_rn(dc, dc, sq[k]);
      }
    }
  } else {
    chunk_stats_long<FMT>(ema_px, ctl0, t, tile, frame_bytes, plane_px, offset, u8_scale,
                          alpha, one_minus_alpha, rcp_tile, s, sq);
  }
}

// Grid: one block per kLanes thread items (for p12 an item is two pixels).
template <int FMT, int TILE>
__global__ void __launch_bounds__(kLanes * kChunkLanes, kMinBlocks<FMT>)
    ema_kernel(const uint8_t* __restrict__ frames, float* __restrict__ ema,
               float* __restrict__ mean, float* __restrict__ m2, int chunks,
               int plane_items, int64_t frame_bytes, int pair_tile, float offset,
               float u8_scale, float alpha, float one_minus_alpha, float prior,
               float rcp_tile) {
  constexpr int P = Item<FMT>::kPixels;
  __shared__ float2 stats[2][kChunkLanes][P][kLanes];  // (s, sq) of each chunk and pixel
  __shared__ float2 weights[2][kChunkLanes];           // (r, c) of each chunk's merge
  const int lane = threadIdx.x % kLanes;
  const int r = threadIdx.x / kLanes;
  const bool live = static_cast<int64_t>(blockIdx.x) * kLanes + lane < plane_items;
  const int t = live ? blockIdx.x * kLanes + lane : 0;
  const bool merger = r == 0 && live;
  const int64_t plane_px = static_cast<int64_t>(plane_items) * P;
  const float m = static_cast<float>(pair_tile);
  const bool windowed = pair_tile > kLanesMax;
  float mu[P], var[P];
  if (merger) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      mu[k] = mean[static_cast<int64_t>(t) * P + k];
      var[k] = m2[static_cast<int64_t>(t) * P + k];
    }
  }
  const int rounds = (chunks + kChunkLanes - 1) / kChunkLanes;
  for (int round = 0; round < rounds; ++round) {
    const int buf = round & 1;
    const int c = round * kChunkLanes + r;
    if (c < chunks) {
      float s[P], sq[P];
      if (live) {
        chunk_stats<FMT, TILE>(frames, ema, t, static_cast<int64_t>(c) * pair_tile, pair_tile,
                         frame_bytes, plane_px, offset, u8_scale, alpha, one_minus_alpha,
                         rcp_tile, s, sq);
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) s[k] = sq[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < P; ++k) stats[buf][r][k][lane] = make_float2(s[k], sq[k]);
      if (lane == 0) {
        const float n = __fadd_rn(prior, __fmul_rn(static_cast<float>(c), m));
        const float tot = __fadd_rn(n, m);
        weights[buf][r] = make_float2(__fdiv_rn(m, tot), __fdiv_rn(__fmul_rn(n, m), tot));
      }
    }
    __syncthreads();
    if (merger) {  // the round's chunks, in chunk order
      const int count = min(kChunkLanes, chunks - round * kChunkLanes);
#pragma unroll
      for (int j = 0; j < kChunkLanes; ++j) {
        if (j < count) {
          const float2 w = weights[buf][j];
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float2 st = stats[buf][j][k][lane];
            const float dp = windowed ? __fmaf_rn(st.x, rcp_tile, -mu[k])
                                      : __fsub_rn(__fmul_rn(st.x, rcp_tile), mu[k]);
            var[k] = __fadd_rn(var[k], __fmaf_rn(__fmul_rn(dp, dp), w.y, st.y));
            mu[k] = __fmaf_rn(__fmaf_rn(st.x, rcp_tile, -mu[k]), w.x, mu[k]);
          }
        }
      }
    }
  }
  if (merger) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      mean[static_cast<int64_t>(t) * P + k] = mu[k];
      m2[static_cast<int64_t>(t) * P + k] = var[k];
    }
  }
}

template <int FMT, int TILE>
cudaError_t launch_tile(const void* frames, void* ema, void* mean, void* m2,
                        int pairs, int plane_items, int64_t frame_bytes,
                        int pair_tile, float offset, float u8_scale, float alpha,
                        float one_minus_alpha, float prior, float rcp_tile,
                        cudaStream_t stream) {
  const int blocks = (plane_items + kLanes - 1) / kLanes;
  ema_kernel<FMT, TILE><<<blocks, kLanes * kChunkLanes, 0, stream>>>(
      static_cast<const uint8_t*>(frames), static_cast<float*>(ema),
      static_cast<float*>(mean), static_cast<float*>(m2), pairs / pair_tile,
      plane_items, frame_bytes, pair_tile, offset, u8_scale, alpha,
      one_minus_alpha, prior, rcp_tile);
  return cudaGetLastError();
}

// One kernel per format and register tile: pair_tile 1 .. kCap, and 0 above.
template <int FMT>
cudaError_t launch(const void* frames, void* ema, void* mean, void* m2,
                   int pairs, int plane_items, int64_t frame_bytes,
                   int pair_tile, float offset, float u8_scale, float alpha,
                   float one_minus_alpha, float prior, float rcp_tile,
                   cudaStream_t stream) {
  static_assert(kCap == 8, "the switch below lists the register tiles 1 .. kCap");
#define TILE(T) launch_tile<FMT, T>(frames, ema, mean, m2, pairs, plane_items, frame_bytes, pair_tile, offset, u8_scale, alpha, one_minus_alpha, prior, rcp_tile, stream)
  switch (pair_tile) {
    case 1: return TILE(1);
    case 2: return TILE(2);
    case 3: return TILE(3);
    case 4: return TILE(4);
    case 5: return TILE(5);
    case 6: return TILE(6);
    case 7: return TILE(7);
    case 8: return TILE(8);
    default: return TILE(0);
  }
#undef TILE
}

// XLA's float32 order for a sum of the m values v(0), ..., v(m - 1), by m
// (the orders above): one chain up to kChainMax, 8 lanes folded pairwise and
// the rest chained on up to kLanesMax, zero-padded windows of kWindow above.
template <typename V>
__device__ __forceinline__ float ordered_sum(int m, V&& v) {
  if (m <= kChainMax) {
    float s = 0.0f;
    for (int i = 0; i < m; ++i) s = __fadd_rn(s, v(i));
    return s;
  }
  if (m <= kLanesMax) {
    const int full = m / 8 * 8;
    float lane[8][1] = {};
    for (int i0 = 0; i0 < full; i0 += 8)
#pragma unroll
      for (int l = 0; l < 8; ++l) lane[l][0] = __fadd_rn(lane[l][0], v(i0 + l));
    float s[1];
    fold_lanes<1>(lane, s);
    for (int i = full; i < m; ++i) s[0] = __fadd_rn(s[0], v(i));
    return s[0];
  }
  const int padded = (m + kWindow - 1) / kWindow * kWindow;
  const int low = (padded - m) / 2;
  float s = 0.0f, part = 0.0f;
  for (int i = 0; i < m; ++i) {
    if (i > 0 && (i + low) % kWindow == 0) {
      s = __fadd_rn(s, part);
      part = 0.0f;
    }
    part = __fadd_rn(part, v(i));
  }
  return __fadd_rn(s, part);
}

// A float16 or bfloat16 state (A, quant.cuh Acc): one thread per thread item
// (a pixel, or a p12 pixel pair), the chunks in order. The arithmetic is the
// plain version's (kernels/denoise_ema.py ema_welford_step_plain), which
// follows what XLA makes of the reference's kernel for a half type:
//   ema'  = fma(ema, 1 - a, a * d) as one float16 FMA; for bfloat16
//           ema * (1 - a) + a * d, every operation rounded;
//   cm    = A(s * f32(1/m)), s the float32 sum of the chunk's d in the
//           order of its length; for bfloat16 the sum reads each d before
//           the rounding of its last add (pair_diff_acc's `wide`), as XLA
//           computes that add in float32;
//   chunk = A(float32 sum of the squares of A(d - cm)), a square rounded to
//           float16, exact in float32 for bfloat16;
//   n = prior + A(k) * m, tot = n + m, r = m / tot, c = (n * m) / tot,
//   delta = cm - mean, all in A;
//   mean' = fma(delta, r, mean), M2' = M2 + fma(delta^2, c, chunk) for
//           float16 (one FMA each); for bfloat16 mean + delta * r and
//           M2 + (chunk + delta^2 * c), every operation rounded.
// A correct, simple kernel: each thread re-reads a chunk's wire pairs for
// each of its three passes.
template <int FMT, typename A>
__global__ void __launch_bounds__(256)
    ema_half_kernel(const uint8_t* __restrict__ frames, A* __restrict__ ema,
                    A* __restrict__ mean, A* __restrict__ m2, int chunks, int plane_items,
                    int64_t frame_bytes, int pair_tile, float offset, float u8_scale,
                    float alpha, float one_minus_alpha, float prior, float rcp_tile) {
  using repro_quant::Acc;
  using repro_quant::acc_add;
  using repro_quant::acc_div;
  using repro_quant::acc_mul;
  using repro_quant::acc_sub;
  constexpr int P = Item<FMT>::kPixels;
  constexpr bool kBf16 = std::is_same_v<A, __nv_bfloat16>;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= plane_items) return;
  const int64_t plane_px = static_cast<int64_t>(plane_items) * P;
  const float m = Acc<A>::round(static_cast<float>(pair_tile));
  float mu[P], var[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    mu[k] = Acc<A>::load(mean[static_cast<int64_t>(t) * P + k]);
    var[k] = Acc<A>::load(m2[static_cast<int64_t>(t) * P + k]);
  }
  for (int c = 0; c < chunks; ++c) {
    const int64_t p0 = static_cast<int64_t>(c) * pair_tile;
    auto diff = [&](int i, float (&d)[P], float (&w)[P]) {
      const uint8_t* ctl = frames + 2 * (p0 + i) * frame_bytes;
      pair_diff_acc<FMT, A>(ctl, ctl + frame_bytes, t, offset, u8_scale, d, w);
    };
    for (int i = 0; i < pair_tile; ++i) {
      float d[P], w[P];
      diff(i, d, w);
      A* e = ema + (p0 + i) * plane_px + static_cast<int64_t>(t) * P;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float ev = Acc<A>::load(e[k]), ad = acc_mul<A>(alpha, d[k]);
        if constexpr (Acc<A>::kContracts) {
          e[k] = Acc<A>::store(Acc<A>::fma(ev, one_minus_alpha, ad));
        } else {
          e[k] = Acc<A>::store(acc_add<A>(acc_mul<A>(ev, one_minus_alpha), ad));
        }
      }
    }
    const float n = acc_add<A>(prior, acc_mul<A>(Acc<A>::round(static_cast<float>(c)), m));
    const float tot = acc_add<A>(n, m);
    const float r = acc_div<A>(m, tot), cw = acc_div<A>(acc_mul<A>(n, m), tot);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float s = ordered_sum(pair_tile, [&](int i) {
        float d[P], w[P];
        diff(i, d, w);
        return kBf16 ? w[k] : d[k];
      });
      const float cm = Acc<A>::round(__fmul_rn(s, rcp_tile));
      const float sq = ordered_sum(pair_tile, [&](int i) {
        float d[P], w[P];
        diff(i, d, w);
        const float dc = acc_sub<A>(d[k], cm);
        return kBf16 ? __fmul_rn(dc, dc) : acc_mul<A>(dc, dc);
      });
      const float chunk = Acc<A>::round(sq);
      const float delta = acc_sub<A>(cm, mu[k]);
      const float dd = acc_mul<A>(delta, delta);
      if constexpr (Acc<A>::kContracts) {
        mu[k] = Acc<A>::fma(delta, r, mu[k]);
        var[k] = acc_add<A>(var[k], Acc<A>::fma(dd, cw, chunk));
      } else {
        mu[k] = acc_add<A>(mu[k], acc_mul<A>(delta, r));
        var[k] = acc_add<A>(var[k], acc_add<A>(chunk, acc_mul<A>(dd, cw)));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    mean[static_cast<int64_t>(t) * P + k] = Acc<A>::store(mu[k]);
    m2[static_cast<int64_t>(t) * P + k] = Acc<A>::store(var[k]);
  }
}

template <typename A>
cudaError_t launch_half(int fmt, const void* frames, void* ema, void* mean, void* m2,
                        int pairs, int plane_items, int64_t frame_bytes, int pair_tile,
                        float offset, float u8_scale, float alpha, float one_minus_alpha,
                        float prior, float rcp_tile, cudaStream_t stream) {
  const int blocks = (plane_items + 255) / 256;
#define HALF(F)                                                                              \
  ema_half_kernel<F, A><<<blocks, 256, 0, stream>>>(                                         \
      static_cast<const uint8_t*>(frames), static_cast<A*>(ema), static_cast<A*>(mean),       \
      static_cast<A*>(m2), pairs / pair_tile, plane_items, frame_bytes, pair_tile, offset,    \
      u8_scale, alpha, one_minus_alpha, prior, rcp_tile)
  switch (fmt) {
    case kU16: HALF(kU16); break;
    case kU8: HALF(kU8); break;
    case kP12: HALF(kP12); break;
    default: return cudaErrorInvalidValue;
  }
#undef HALF
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `frames` is one group (N, H, wire_W); `ema` (N/2, H, W); `mean` and `m2`
// (H, W), all of the type `acc` (AccumCode: float32, float16 or bfloat16)
// and updated in place. `items` is W, or W/2 for p12; `pair_tile` divides
// `pairs`; `prior` is the sample count already merged. The constants come
// rounded to the state's type, but `rcp_tile`, float32 1/pair_tile.
int ema_welford_step_launch(const void* frames, void* ema, void* mean,
                            void* m2, int64_t pairs, int64_t height,
                            int64_t items, int64_t row_bytes,
                            int64_t pair_tile, int fmt, float offset,
                            float u8_scale, float alpha, float one_minus_alpha,
                            float prior, float rcp_tile, int acc, void* stream) {
  if (pairs == 0 || height == 0 || items == 0) return cudaSuccess;
  // a p12 item is 3 wire bytes at byte 3 * item of its plane: keep that an int
  if (pair_tile < 1 || pairs % pair_tile || pairs > 0x3fffffff ||
      3 * height * items > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(pairs), tp = static_cast<int>(pair_tile);
  const int plane_items = static_cast<int>(height * items);
  const int64_t frame_bytes = height * row_bytes;
  if (acc == kAccF16 || acc == kAccBF16) {
    return acc == kAccF16
               ? launch_half<__half>(fmt, frames, ema, mean, m2, p, plane_items, frame_bytes, tp,
                                     offset, u8_scale, alpha, one_minus_alpha, prior, rcp_tile, s)
               : launch_half<__nv_bfloat16>(fmt, frames, ema, mean, m2, p, plane_items,
                                            frame_bytes, tp, offset, u8_scale, alpha,
                                            one_minus_alpha, prior, rcp_tile, s);
  }
  if (acc != kAccF32) return cudaErrorInvalidValue;
#define EMA(F) launch<F>(frames, ema, mean, m2, p, plane_items, frame_bytes, tp, offset, u8_scale, alpha, one_minus_alpha, prior, rcp_tile, s)
  switch (fmt) {
    case kU16: return EMA(kU16);
    case kU8: return EMA(kU8);
    case kP12: return EMA(kP12);
  }
#undef EMA
  return cudaErrorInvalidValue;
}

}  // extern "C"
