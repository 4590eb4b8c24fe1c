// Hopper kernels for the temporal-median streaming filter.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   median_window_insert  <- src/repro/kernels/denoise_median.py median_window_insert (_insert_kernel)
//   median_combine        <- src/repro/kernels/denoise_median.py median_combine (_median_kernel)
// The insert fuses the shared dequantization prologue (B1, quant.cuh).
//
// Bound: HBM bytes for both. The insert reads one group of wire frames and
// writes one window slot: some three operations per pixel. The
// combine reads K float32 slots and writes one frame; its min/max network
// does K(K-1)/2 compare-exchanges per pixel, 10 for K = 5, far below the
// ridge.
//
// Design:
//   * insert, two paths chosen on the host (denoise_median.insert_path) and
//     passed as a flag; a vector launch on operands that do not allow it is
//     refused, never rerouted. Only window[slot], an (N/2, H, W) frame, is
//     written; the other K-1 slots are never touched (the TPU kernel aliases
//     the donated window for the same reason).
//       - vector path (every wire format and window type, where H*W is a
//         multiple of the vector and the planes are aligned): a thread takes
//         B3's wire vectors (WireVec, quant.cuh: 8 u16 pixels in one 16-byte
//         load, 16 u8 in one, 16 p12 in three 8-byte loads), two of them,
//         issues all their loads before any store, and stores 16-byte words
//         of the slot (four float32 pixels, or eight halves in packed pairs),
//         a warp's 512 consecutive bytes a store instruction. The
//         difference is vec_diff/vec_diff2 (quant.cuh), the one-shot's own,
//         so it rounds as pair_diff_as. 512 vectors of a pair's planes a
//         block, one layout: a plan's geometry is validated, not taken;
//       - scalar path (a ragged plane, an unaligned view): one thread per
//         output pixel (two for p12), one block per (pair, image row) by
//         default, threads along W (a plan's row_tile x pair_tile rows a
//         block, the kernel's tiled form).
//     Every geometry and both paths give the same bits;
//   * combine: one thread per output pixel over the flat (N/2)*H*W range;
//     each thread loads its K values (coalesced: neighbouring threads read
//     neighbouring pixels of each slot) and runs the reference's odd-even
//     transposition network with fminf/fmaxf. K <= 8 is unrolled into
//     registers; 8 < K <= 64 runs the same network with runtime bounds over
//     a thread-local array. Even K returns (lo + hi) * 0.5f, the jitted
//     reference's mid / 2.
//   * combine, K > 64 (no register array holds the column): an exact
//     selection of the middle ranks. The thread reads its column of K values
//     from memory, and for each candidate counts the values below it and
//     those at most it; the candidate whose range of ranks holds rank K/2
//     (and K/2 - 1 for even K) is the value the sorting network leaves there.
//     O(K^2) reads from L1/L2 a pixel, no memory beyond registers, any K.
//
// min/max and the final * 0.5f are exact, so the median is the value the
// reference's network or jnp.sort picks, bit for bit. A float16 or bfloat16
// window (quant.cuh Acc) takes the same kernels: values are widened to float
// on load, the even-K add rounds to the window's type, and the result is
// stored in it. (So is a selection by
// rank: the values are the diffs of wire pixels, with no NaN and no -0.)

#include "quant.cuh"

namespace {

using namespace repro_quant;

constexpr int kMaxWindow = 64;

// B6: window slot = exc - ctl + offset of one group, one row (pair p, image row
// h). The kernel's untiled form (TILED = false) is one block per row; a plan's
// geometry (TILED = true) is rt x pt rows a block (for_tile_rows, quant.cuh).
// A is the window's type (float, __half or __nv_bfloat16; quant.cuh Acc).
template <int FMT, typename A>
__device__ __forceinline__ void insert_row(const uint8_t* __restrict__ frames,
                                           A* __restrict__ slot, int64_t p, int64_t h,
                                           int height, int items, int64_t row_bytes,
                                           float offset, float u8_scale) {
  constexpr int P = Item<FMT>::kPixels;
  const uint8_t* ctl = frames + ((2 * p) * height + h) * row_bytes;
  const uint8_t* exc = ctl + height * row_bytes;
  A* out = slot + (p * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    float d[P];
    pair_diff_as<FMT, A>(ctl, exc, x, offset, u8_scale, d);
#pragma unroll
    for (int k = 0; k < P; ++k) out[x * P + k] = Acc<A>::store(d[k]);
  }
}

template <int FMT, bool TILED, typename A>
__global__ void insert_kernel(const uint8_t* __restrict__ frames,
                              A* __restrict__ slot, int64_t pairs, int height, int items,
                              int64_t row_bytes, int rt, int pt, float offset, float u8_scale) {
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      insert_row<FMT, A>(frames, slot, p, h, height, items, row_bytes, offset, u8_scale);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    insert_row<FMT, A>(frames, slot, p, r - p * height, height, items, row_bytes, offset,
                       u8_scale);
  }
}

// B6, vector path, one layout: block (x, y) takes vectors [512x, 512x + 512)
// of the planes of pair y (and of y + gridDim.y, ... when there are more
// pairs than a grid row holds); thread i takes vectors 512x + i and 512x +
// 256 + i. A plan's geometry is validated and changes nothing here: each one
// the launch model offers measured slower than this layout on the H100, or
// equal within noise (PERF.md section 6), as the one-shot's vector path did.
//
// A vector's differences are kWords 16-byte words of the slot (its 8 or 16
// pixels as float32 or as a half type). A warp's 32 vectors are consecutive,
// so their words are too; where a vector is more than one word, the words
// pass through the warp's staging buffer in shared memory, and each store
// instruction of the warp writes 512 consecutive bytes (one lane's words
// side by side left each store a half or a quarter of its sectors, and the
// float32 slots at 33-58 % of the byte bound). The buffer's words are
// XOR-swizzled so that neither side conflicts on banks: lane l puts its word
// k at l * kWords + (k ^ ((l / (8 / kWords)) % kWords)).
constexpr int kInsertThreads = 256;
constexpr int kInsertPerThread = 2;
constexpr int kInsertPerBlock = kInsertThreads * kInsertPerThread;

template <int FMT, typename A>
constexpr int kWords = WireVec<FMT>::kPixels * static_cast<int>(sizeof(A)) / 16;

// Word q of one vector's differences in the slot: pixels 4q..4q+3 as
// float32, or 8q..8q+7 as four packed pairs of a half type.
template <int FMT, typename A>
__device__ __forceinline__ uint4 diff_word(const WireVec<FMT>& c, const WireVec<FMT>& e, int q,
                                           float offset, float u8_scale) {
  if constexpr (std::is_same_v<A, float>) {
    return make_uint4(__float_as_uint(vec_diff<FMT>(c, e, 4 * q, offset, u8_scale)),
                      __float_as_uint(vec_diff<FMT>(c, e, 4 * q + 1, offset, u8_scale)),
                      __float_as_uint(vec_diff<FMT>(c, e, 4 * q + 2, offset, u8_scale)),
                      __float_as_uint(vec_diff<FMT>(c, e, 4 * q + 3, offset, u8_scale)));
  } else {
    using H = Half2<A>;
    using T = typename H::T;
    const T off = H::splat(offset), scale = H::splat(u8_scale);
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T d = vec_diff2<FMT, A>(c, e, 4 * q + j, off, scale);
      r[j] = *reinterpret_cast<const uint32_t*>(&d);
    }
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// Where word k of lane l's vector sits in the warp's staging buffer.
template <int W>
__device__ __forceinline__ int staged(int l, int k) {
  return l * W + (k ^ ((l / (8 / W)) % W));
}

// Insert vectors v0 and v0 + 256 of one pair's planes, those below `end`;
// v0 is the warp's first vector plus the lane, and every lane of the warp
// calls this (the staging buffer's __syncwarp).
template <int FMT, typename A>
__device__ __forceinline__ void insert_vectors(const uint8_t* __restrict__ ctl,
                                               const uint8_t* __restrict__ exc,
                                               A* __restrict__ out, int64_t v0, int64_t end,
                                               float offset, float u8_scale,
                                               uint4* __restrict__ stage) {
  constexpr int W = kWords<FMT, A>;
  WireVec<FMT> c[kInsertPerThread], e[kInsertPerThread];
#pragma unroll
  for (int u = 0; u < kInsertPerThread; ++u) {  // every load before any store
    const int64_t v = v0 + u * kInsertThreads;
    if (v < end) {
      c[u] = load_vec<FMT>(ctl, v);
      e[u] = load_vec<FMT>(exc, v);
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kInsertPerThread; ++u) {
    const int64_t base = v0 - lane + u * kInsertThreads;  // the same in every lane
    if (base < end) {
      const bool mine = base + lane < end;
      uint4* dst = reinterpret_cast<uint4*>(out) + base * W;
      if constexpr (W == 1) {
        if (mine) dst[lane] = diff_word<FMT, A>(c[u], e[u], 0, offset, u8_scale);
      } else {
        if (mine) {
#pragma unroll
          for (int k = 0; k < W; ++k)
            stage[staged<W>(lane, k)] = diff_word<FMT, A>(c[u], e[u], k, offset, u8_scale);
        }
        __syncwarp();
        const int valid = end - base < 32 ? static_cast<int>(end - base) : 32;
#pragma unroll
        for (int k = 0; k < W; ++k) {  // word m of the warp's run: lane m / W's word m % W
          const int m = k * 32 + lane;
          if (m / W < valid) dst[m] = stage[staged<W>(m / W, m % W)];
        }
        __syncwarp();
      }
    }
  }
}

template <int FMT, typename A>
__global__ void __launch_bounds__(kInsertThreads)
    insert_vec_kernel(const uint8_t* __restrict__ frames, A* __restrict__ slot, int64_t pairs,
                      int64_t vectors, int64_t plane_bytes, float offset, float u8_scale) {
  constexpr int K = WireVec<FMT>::kPixels, W = kWords<FMT, A>;
  __shared__ uint4 staging[kInsertThreads / 32][W > 1 ? 32 * W : 1];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kInsertPerBlock + threadIdx.x;
  for (int64_t p = blockIdx.y; p < pairs; p += gridDim.y) {
    const uint8_t* ctl = frames + 2 * p * plane_bytes;
    insert_vectors<FMT, A>(ctl, ctl + plane_bytes, slot + p * vectors * K, v0, vectors, offset,
                           u8_scale, staging[threadIdx.x / 32]);
  }
}

// (lo + hi) / 2 in the window's type: the add rounds to it, the halving is exact.
template <typename A>
__device__ __forceinline__ float mid_mean(float lo, float hi) {
  return acc_mul<A>(acc_add<A>(lo, hi), 0.5f);
}

// The reference's odd-even transposition network over v[0..count).
template <int K, typename A>
__device__ __forceinline__ float median_network(float* v, int count) {
  const int n = K > 0 ? K : count;
#pragma unroll
  for (int rnd = 0; rnd < n; ++rnd) {
#pragma unroll
    for (int i = rnd % 2; i < n - 1; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      const float hi = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
      v[i + 1] = hi;
    }
  }
  if (n % 2) return v[n / 2];
  return mid_mean<A>(v[n / 2 - 1], v[n / 2]);
}

// B7: per-pixel median over the K leading slots. K > 0 is a compile-time
// window (registers); K == 0 takes `count` at run time (<= kMaxWindow).
template <int K, typename A>
__global__ void combine_kernel(const A* __restrict__ window,
                               A* __restrict__ out, int64_t plane,
                               int count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float v[K > 0 ? K : kMaxWindow];
  const int n = K > 0 ? K : count;
#pragma unroll
  for (int k = 0; k < (K > 0 ? K : kMaxWindow); ++k) {
    if (k < n) v[k] = Acc<A>::load(window[k * plane + i]);
  }
  out[i] = Acc<A>::store(median_network<K, A>(v, n));
}

// B7, K > kMaxWindow: the values of ranks lo = (K-1)/2 and hi = K/2 of the
// column by counting. A value v holds every rank in [#{< v}, #{<= v}).
template <typename A>
__global__ void combine_select_kernel(const A* __restrict__ window,
                                      A* __restrict__ out, int64_t plane,
                                      int count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const A* col = window + i;
  const int lo = (count - 1) / 2, hi = count / 2;
  float v_lo = 0.0f, v_hi = 0.0f;
  bool got_lo = false, got_hi = false;
  for (int c = 0; c < count && !(got_lo && got_hi); ++c) {
    const float v = Acc<A>::load(col[c * plane]);
    int below = 0, upto = 0;
    for (int k = 0; k < count; ++k) {
      const float x = Acc<A>::load(col[k * plane]);
      below += x < v;
      upto += x <= v;
    }
    if (!got_lo && below <= lo && lo < upto) v_lo = v, got_lo = true;
    if (!got_hi && below <= hi && hi < upto) v_hi = v, got_hi = true;
  }
  out[i] = Acc<A>::store(count % 2 ? v_hi : mid_mean<A>(v_lo, v_hi));
}

// The vector path's one layout, or the scalar layout's rows in rt x pt tiles.
template <int FMT, typename A>
cudaError_t launch_insert(const void* frames, void* slot, int64_t pairs,
                          int height, int items, int64_t row_bytes, int rt, int pt, bool tiled,
                          bool vector, float offset, float u8_scale, cudaStream_t stream) {
  if (vector) {
    const int64_t vectors =
        static_cast<int64_t>(height) * items * Item<FMT>::kPixels / WireVec<FMT>::kPixels;
    const dim3 grid(static_cast<unsigned>((vectors + kInsertPerBlock - 1) / kInsertPerBlock),
                    static_cast<unsigned>(pairs < 65535 ? pairs : 65535));
    insert_vec_kernel<FMT, A><<<grid, kInsertThreads, 0, stream>>>(
        static_cast<const uint8_t*>(frames), static_cast<A*>(slot), pairs, vectors,
        height * row_bytes, offset, u8_scale);
    return cudaGetLastError();
  }
  return in_form(tiled, [&](auto form) {
    insert_kernel<FMT, decltype(form)::value, A>
        <<<static_cast<unsigned>(row_tile_blocks(pairs, height, rt, pt)), threads_for(items), 0,
           stream>>>(static_cast<const uint8_t*>(frames), static_cast<A*>(slot), pairs,
                     height, items, row_bytes, rt, pt, offset, u8_scale);
  });
}

template <int K, typename A>
cudaError_t launch_combine(const void* window, void* out, int64_t plane,
                           int count, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (plane + kThreads - 1) / kThreads;
  combine_kernel<K, A><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const A*>(window), static_cast<A*>(out), plane, count);
  return cudaGetLastError();
}

template <typename A>
cudaError_t combine(const void* window, void* out, int64_t plane, int c, cudaStream_t s) {
  if (c > kMaxWindow) {
    constexpr int kThreads = 256;
    combine_select_kernel<A><<<static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                               kThreads, 0, s>>>(static_cast<const A*>(window),
                                                 static_cast<A*>(out), plane, c);
    return cudaGetLastError();
  }
  switch (c) {
    case 1: return launch_combine<1, A>(window, out, plane, c, s);
    case 2: return launch_combine<2, A>(window, out, plane, c, s);
    case 3: return launch_combine<3, A>(window, out, plane, c, s);
    case 4: return launch_combine<4, A>(window, out, plane, c, s);
    case 5: return launch_combine<5, A>(window, out, plane, c, s);
    case 6: return launch_combine<6, A>(window, out, plane, c, s);
    case 7: return launch_combine<7, A>(window, out, plane, c, s);
    case 8: return launch_combine<8, A>(window, out, plane, c, s);
  }
  return launch_combine<0, A>(window, out, plane, c, s);
}

// A launch for the window's type: float, __half or __nv_bfloat16 (acc).
template <typename F>
cudaError_t on_window_type(int acc, F&& launch) {
  switch (acc) {
    case kAccF32: return launch(float{});
    case kAccF16: return launch(__half{});
    case kAccBF16: return launch(__nv_bfloat16{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, loaded with ctypes; each returns the cudaError_t of
// its launch (0 = launched).
extern "C" {

// `frames` is one group (N, H, wire_W); `slot` points at window[slot], an
// (N/2, H, W) frame of the window's type `acc` (AccumCode: float32, float16
// or bfloat16). `items` is W, or W/2 for p12. `row_tile` and `pair_tile`
// (0 = the default geometry) are the image rows and pairs a block covers on
// the scalar path; the vector path validates them and keeps its layout. `vector`
// selects the vector path; the host sets it only where the planes allow it
// (denoise_median.insert_path), and a launch that asks for it on planes that
// do not returns cudaErrorInvalidValue.
int median_window_insert_launch(const void* frames, void* slot, int64_t pairs,
                                int64_t height, int64_t items,
                                int64_t row_bytes, int fmt, int vector, float offset,
                                float u8_scale, int64_t row_tile, int64_t pair_tile,
                                int acc, void* stream) {
  const int64_t rows = pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t rt = row_tile ? row_tile : 1, pt = pair_tile ? pair_tile : 1;
  if (row_tile < 0 || pair_tile < 0 || !row_tiles_ok(pairs, height, rt, pt))
    return cudaErrorInvalidValue;
  const int64_t plane_px = height * items * (fmt == kP12 ? 2 : 1);
  if (vector && !wire_vectors_ok(fmt, plane_px, frames, slot)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  const int r = static_cast<int>(rt), q = static_cast<int>(pt);
  const bool tiled = row_tile != 0 || pair_tile != 0;
  return on_window_type(acc, [&](auto zero) {
    using A = decltype(zero);
#define INSERT(F) launch_insert<F, A>(frames, slot, pairs, h, it, row_bytes, r, q, tiled, \
                                      vector != 0, offset, u8_scale, s)
    switch (fmt) {
      case kU16: return INSERT(kU16);
      case kU8: return INSERT(kU8);
      case kP12: return INSERT(kP12);
    }
#undef INSERT
    return cudaErrorInvalidValue;
  });
}

// `window` is the filled prefix (count, plane) and `out` (plane,), both of
// the window's type `acc` (float32, float16 or bfloat16).
int median_combine_launch(const void* window, void* out, int64_t count,
                          int64_t plane, int acc, void* stream) {
  if (plane == 0) return cudaSuccess;
  if (count < 1 || count > 0x7fffffff || (plane + 255) / 256 > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(count);
  return on_window_type(acc, [&](auto zero) {
    return combine<decltype(zero)>(window, out, plane, c, s);
  });
}

}  // extern "C"
