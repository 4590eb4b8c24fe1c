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
// One body serves every state type A (float, __half, __nv_bfloat16;
// quant.cuh Acc): the EMA and the statistics planes are loaded and stored
// as A, every value travels as a float, and only the rounding differs by
// type (below). The chunk sums stay float32 in every type.
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
// each operation below is written with an _rn intrinsic in that order. For
// a float32 state:
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
// A float16 or bfloat16 state follows what XLA makes of the reference's
// kernel in that type (the plain version, ema_welford_step_plain):
//   ema'  = fma(ema, 1 - a, a * d) as one float16 FMA; for bfloat16
//           ema * (1 - a) + a * d, every operation rounded;
//   s     = the float32 sum of the chunk's d in the order of its length;
//           for bfloat16 the sum reads each d before the rounding of its
//           last add (pair_diff_acc's `wide`), as XLA computes that add in
//           float32; cm = A(s * f32(1/m));
//   chunk = A(float32 sum, in the same order, of the squares of
//           dc = A(d - cm)), a square rounded to float16, exact in float32
//           for bfloat16;
//   n = prior + A(k) * m, tot = n + m, r = m / tot, c = (n * m) / tot,
//   delta = cm - mean, all in A;
//   mean' = fma(delta, r, mean), M2' = M2 + fma(delta^2, c, chunk) for
//           float16 (one FMA each); for bfloat16 mean + delta * r and
//           M2 + (chunk + delta^2 * c), every operation rounded.

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

// The pair at wire frame ctl (control; excitation one frame on), thread
// item t: d of each pixel, rounded to A, and w, what the chunk sum adds: d,
// or for bfloat16 the d before its last rounding.
template <int FMT, typename A>
__device__ __forceinline__ void load_diff(const uint8_t* __restrict__ ctl, int t,
                                          int64_t frame_bytes, float offset, float u8_scale,
                                          float (&d)[Item<FMT>::kPixels],
                                          float (&w)[Item<FMT>::kPixels]) {
  if constexpr (std::is_same_v<A, __nv_bfloat16>) {
    pair_diff_acc<FMT, A>(ctl, ctl + frame_bytes, t, offset, u8_scale, d, w);
  } else {
    pair_diff_as<FMT, A>(ctl, ctl + frame_bytes, t, offset, u8_scale, d);
#pragma unroll
    for (int k = 0; k < Item<FMT>::kPixels; ++k) w[k] = d[k];
  }
}

// ema * (1 - a) + a * d: one FMA where A contracts, else every operation rounded.
template <typename A>
__device__ __forceinline__ float ema_update(float e, float d, float alpha, float one_minus_alpha) {
  const float ad = acc_mul<A>(alpha, d);
  if constexpr (Acc<A>::kContracts) return Acc<A>::fma(e, one_minus_alpha, ad);
  return acc_add<A>(acc_mul<A>(e, one_minus_alpha), ad);
}

// The chunk mean cm = A(s * f32(1/m)).
template <typename A>
__device__ __forceinline__ float chunk_mean(float s, float rcp_tile) {
  return Acc<A>::round(__fmul_rn(s, rcp_tile));
}

// dc^2 as the sum of squares adds it: rounded to float16 for a float16
// state, else the float32 product (exact for bfloat16).
template <typename A>
__device__ __forceinline__ float square(float dc) {
  if constexpr (std::is_same_v<A, __half>) return acc_mul<A>(dc, dc);
  return __fmul_rn(dc, dc);
}

// sq + dc^2 in the chain and lane orders: one FMA for float32, else the
// square added.
template <typename A>
__device__ __forceinline__ float add_square(float sq, float dc) {
  if constexpr (std::is_same_v<A, float>) return __fmaf_rn(dc, dc, sq);
  return __fadd_rn(sq, square<A>(dc));
}

// The centred value of the windowed order: fma(-s, 1/m, d) for float32,
// A(d - cm) otherwise.
template <typename A>
__device__ __forceinline__ float centred_windowed(float d, float s, float cm, float rcp_tile) {
  if constexpr (std::is_same_v<A, float>) return __fmaf_rn(-s, rcp_tile, d);
  return acc_sub<A>(d, cm);
}

// Chan's merge of a chunk's (s, sq) with weights w = (r, c) into (mu, var).
template <typename A>
__device__ __forceinline__ void merge(float s, float sq, float2 w, float rcp_tile, bool windowed,
                                      float& mu, float& var) {
  if constexpr (std::is_same_v<A, float>) {
    const float dp = windowed ? __fmaf_rn(s, rcp_tile, -mu) : __fsub_rn(__fmul_rn(s, rcp_tile), mu);
    var = __fadd_rn(var, __fmaf_rn(__fmul_rn(dp, dp), w.y, sq));
    mu = __fmaf_rn(__fmaf_rn(s, rcp_tile, -mu), w.x, mu);
  } else {
    const float delta = acc_sub<A>(chunk_mean<A>(s, rcp_tile), mu);
    const float dd = acc_mul<A>(delta, delta), chunk = Acc<A>::round(sq);
    if constexpr (Acc<A>::kContracts) {
      mu = Acc<A>::fma(delta, w.x, mu);
      var = acc_add<A>(var, Acc<A>::fma(dd, w.y, chunk));
    } else {
      mu = acc_add<A>(mu, acc_mul<A>(delta, w.x));
      var = acc_add<A>(var, acc_add<A>(chunk, acc_mul<A>(dd, w.y)));
    }
  }
}

// A chunk longer than kCap pairs (TILE 0) at thread item t, s and sq zeroed:
// the first pass updates the EMA and forms s, the second re-reads the wire
// pairs for the centred squares, each pass in the chunk length's order.
template <int FMT, typename A>
__device__ __forceinline__ void chunk_stats_long(
    A* __restrict__ ema_px, const uint8_t* __restrict__ ctl0, int t, int tile,
    int64_t frame_bytes, int64_t plane_px, float offset, float u8_scale, float alpha,
    float one_minus_alpha, float rcp_tile, float (&s)[Item<FMT>::kPixels],
    float (&sq)[Item<FMT>::kPixels]) {
  constexpr int P = Item<FMT>::kPixels;
  auto diff = [&](int i, float (&d)[P], float (&w)[P]) {
    load_diff<FMT, A>(ctl0 + 2 * i * frame_bytes, t, frame_bytes, offset, u8_scale, d, w);
  };
  auto ema_diff = [&](int i, float (&d)[P], float (&w)[P]) {
    diff(i, d, w);
    A* e = ema_px + i * plane_px;
#pragma unroll
    for (int k = 0; k < P; ++k)
      e[k] = Acc<A>::store(ema_update<A>(Acc<A>::load(e[k]), d[k], alpha, one_minus_alpha));
  };
  float cm[P];
  if (tile <= kChainMax) {
    for (int i = 0; i < tile; ++i) {
      float d[P], w[P];
      ema_diff(i, d, w);
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = __fadd_rn(s[k], w[k]);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) cm[k] = chunk_mean<A>(s[k], rcp_tile);
    for (int i = 0; i < tile; ++i) {
      float d[P], w[P];
      diff(i, d, w);
#pragma unroll
      for (int k = 0; k < P; ++k) sq[k] = add_square<A>(sq[k], acc_sub<A>(d[k], cm[k]));
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
        float d[P], w[P];
        ema_diff(i0 + l, d, w);
#pragma unroll
        for (int k = 0; k < P; ++k) lane[l][k] = __fadd_rn(lane[l][k], w[k]);
      }
    }
    fold_lanes<P>(lane, s);
    for (int i = full; i < tile; ++i) {
      float d[P], w[P];
      ema_diff(i, d, w);
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = __fadd_rn(s[k], w[k]);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) cm[k] = chunk_mean<A>(s[k], rcp_tile);
#pragma unroll
    for (int l = 0; l < 8; ++l)
#pragma unroll
      for (int k = 0; k < P; ++k) lane[l][k] = 0.0f;
    for (int i0 = 0; i0 < full; i0 += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float d[P], w[P];
        diff(i0 + l, d, w);
#pragma unroll
        for (int k = 0; k < P; ++k) lane[l][k] = add_square<A>(lane[l][k], acc_sub<A>(d[k], cm[k]));
      }
    }
    fold_lanes<P>(lane, sq);
    for (int i = full; i < tile; ++i) {
      float d[P], w[P];
      diff(i, d, w);
#pragma unroll
      for (int k = 0; k < P; ++k) sq[k] = add_square<A>(sq[k], acc_sub<A>(d[k], cm[k]));
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
    float d[P], w[P];
    ema_diff(i, d, w);
#pragma unroll
    for (int k = 0; k < P; ++k) part[k] = __fadd_rn(part[k], w[k]);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    s[k] = __fadd_rn(s[k], part[k]);
    part[k] = 0.0f;
    cm[k] = chunk_mean<A>(s[k], rcp_tile);
  }
  for (int i = 0; i < tile; ++i) {
    if (i > 0 && (i + low) % kWindow == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        sq[k] = __fadd_rn(sq[k], part[k]);
        part[k] = 0.0f;
      }
    }
    float d[P], w[P];
    diff(i, d, w);
#pragma unroll
    for (int k = 0; k < P; ++k)
      part[k] = __fadd_rn(part[k], square<A>(centred_windowed<A>(d[k], s[k], cm[k], rcp_tile)));
  }
#pragma unroll
  for (int k = 0; k < P; ++k) sq[k] = __fadd_rn(sq[k], part[k]);
}

// One chunk of pairs [p0, p0 + tile) at thread item t: update the EMA in
// place and return the chunk's sum s and centred sum of squares sq, rounded
// as the contract says. The wire frame of pair p is 2p (control) and 2p + 1
// (excitation); every plane is (H * W) contiguous pixels. TILE is the
// chunk's pair count when it is at most kCap (its diffs stay in registers,
// and each pair's w is folded into s as it is loaded), and 0 for a longer
// chunk (its wire pairs are read twice, and its sums take the order of its
// length).
template <int FMT, int TILE, typename A>
__device__ __forceinline__ void chunk_stats(
    const uint8_t* __restrict__ frames, A* __restrict__ ema, int t, int64_t p0,
    int tile, int64_t frame_bytes, int64_t plane_px, float offset, float u8_scale,
    float alpha, float one_minus_alpha, float rcp_tile, float (&s)[Item<FMT>::kPixels],
    float (&sq)[Item<FMT>::kPixels]) {
  constexpr int P = Item<FMT>::kPixels;
  A* ema_px = ema + p0 * plane_px + static_cast<int64_t>(t) * P;
  const uint8_t* ctl0 = frames + 2 * p0 * frame_bytes;
#pragma unroll
  for (int k = 0; k < P; ++k) s[k] = sq[k] = 0.0f;
  if constexpr (TILE > 0) {
    float d[TILE][P], e[TILE][P];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {  // every load of the chunk before any use
      float w[P];
      load_diff<FMT, A>(ctl0 + 2 * i * frame_bytes, t, frame_bytes, offset, u8_scale, d[i], w);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        e[i][k] = Acc<A>::load(ema_px[i * plane_px + k]);
        s[k] = __fadd_rn(s[k], w[k]);
      }
    }
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int k = 0; k < P; ++k)
        ema_px[i * plane_px + k] =
            Acc<A>::store(ema_update<A>(e[i][k], d[i][k], alpha, one_minus_alpha));
    float cm[P];
#pragma unroll
    for (int k = 0; k < P; ++k) cm[k] = chunk_mean<A>(s[k], rcp_tile);
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int k = 0; k < P; ++k) sq[k] = add_square<A>(sq[k], acc_sub<A>(d[i][k], cm[k]));
  } else {
    chunk_stats_long<FMT, A>(ema_px, ctl0, t, tile, frame_bytes, plane_px, offset, u8_scale,
                             alpha, one_minus_alpha, rcp_tile, s, sq);
  }
}

// Grid: one block per kLanes thread items (for p12 an item is two pixels).
template <int FMT, int TILE, typename A>
__global__ void __launch_bounds__(kLanes * kChunkLanes, kMinBlocks<FMT>)
    ema_kernel(const uint8_t* __restrict__ frames, A* __restrict__ ema,
               A* __restrict__ mean, A* __restrict__ m2, int chunks,
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
  const float m = Acc<A>::round(static_cast<float>(pair_tile));
  const bool windowed = pair_tile > kLanesMax;
  float mu[P], var[P];
  if (merger) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      mu[k] = Acc<A>::load(mean[static_cast<int64_t>(t) * P + k]);
      var[k] = Acc<A>::load(m2[static_cast<int64_t>(t) * P + k]);
    }
  }
  const int rounds = (chunks + kChunkLanes - 1) / kChunkLanes;
  for (int round = 0; round < rounds; ++round) {
    const int buf = round & 1;
    const int c = round * kChunkLanes + r;
    if (c < chunks) {
      float s[P], sq[P];
      if (live) {
        chunk_stats<FMT, TILE, A>(frames, ema, t, static_cast<int64_t>(c) * pair_tile, pair_tile,
                                  frame_bytes, plane_px, offset, u8_scale, alpha,
                                  one_minus_alpha, rcp_tile, s, sq);
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) s[k] = sq[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < P; ++k) stats[buf][r][k][lane] = make_float2(s[k], sq[k]);
      if (lane == 0) {
        const float n = acc_add<A>(prior, acc_mul<A>(Acc<A>::round(static_cast<float>(c)), m));
        const float tot = acc_add<A>(n, m);
        weights[buf][r] = make_float2(acc_div<A>(m, tot), acc_div<A>(acc_mul<A>(n, m), tot));
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
            merge<A>(st.x, st.y, w, rcp_tile, windowed, mu[k], var[k]);
          }
        }
      }
    }
  }
  if (merger) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      mean[static_cast<int64_t>(t) * P + k] = Acc<A>::store(mu[k]);
      m2[static_cast<int64_t>(t) * P + k] = Acc<A>::store(var[k]);
    }
  }
}

// One launch's arguments, as the C entry point takes them.
struct EmaArgs {
  const void* frames;
  void *ema, *mean, *m2;
  int pairs, plane_items;
  int64_t frame_bytes;
  int pair_tile;
  float offset, u8_scale, alpha, one_minus_alpha, prior, rcp_tile;
  cudaStream_t stream;
};

template <int FMT, int TILE, typename A>
cudaError_t launch_tile(const EmaArgs& a) {
  const int blocks = (a.plane_items + kLanes - 1) / kLanes;
  ema_kernel<FMT, TILE, A><<<blocks, kLanes * kChunkLanes, 0, a.stream>>>(
      static_cast<const uint8_t*>(a.frames), static_cast<A*>(a.ema), static_cast<A*>(a.mean),
      static_cast<A*>(a.m2), a.pairs / a.pair_tile, a.plane_items, a.frame_bytes, a.pair_tile,
      a.offset, a.u8_scale, a.alpha, a.one_minus_alpha, a.prior, a.rcp_tile);
  return cudaGetLastError();
}

// One kernel per format, register tile and state type: pair_tile 1 .. kCap,
// and 0 above.
template <int FMT, typename A>
cudaError_t launch(const EmaArgs& a) {
  static_assert(kCap == 8, "the switch below lists the register tiles 1 .. kCap");
  switch (a.pair_tile) {
    case 1: return launch_tile<FMT, 1, A>(a);
    case 2: return launch_tile<FMT, 2, A>(a);
    case 3: return launch_tile<FMT, 3, A>(a);
    case 4: return launch_tile<FMT, 4, A>(a);
    case 5: return launch_tile<FMT, 5, A>(a);
    case 6: return launch_tile<FMT, 6, A>(a);
    case 7: return launch_tile<FMT, 7, A>(a);
    case 8: return launch_tile<FMT, 8, A>(a);
    default: return launch_tile<FMT, 0, A>(a);
  }
}

template <typename A>
cudaError_t launch_format(int fmt, const EmaArgs& a) {
  switch (fmt) {
    case kU16: return launch<kU16, A>(a);
    case kU8: return launch<kU8, A>(a);
    case kP12: return launch<kP12, A>(a);
  }
  return cudaErrorInvalidValue;
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
  const EmaArgs a{frames, ema, mean, m2, static_cast<int>(pairs),
                  static_cast<int>(height * items), height * row_bytes,
                  static_cast<int>(pair_tile), offset, u8_scale, alpha, one_minus_alpha,
                  prior, rcp_tile, static_cast<cudaStream_t>(stream)};
  switch (acc) {
    case kAccF32: return launch_format<float>(fmt, a);
    case kAccF16: return launch_format<__half>(fmt, a);
    case kAccBF16: return launch_format<__nv_bfloat16>(fmt, a);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
