// Hopper kernels for the temporal-median streaming filter.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   median_window_insert  <- src/repro/kernels/denoise_median.py median_window_insert (_insert_kernel)
//   median_combine        <- src/repro/kernels/denoise_median.py median_combine (_median_kernel)
// The insert fuses the shared dequantization prologue (B1, quant.cuh).
//
// Bound: HBM bytes for both. The insert reads one group of wire frames and
// writes one float32 window slot: some three operations per pixel. The
// combine reads K float32 slots and writes one frame; its min/max network
// does K(K-1)/2 compare-exchanges per pixel, 10 for K = 5, far below the
// ridge.
//
// Design (the simple one):
//   * insert: one thread per output pixel (two for p12), one block per
//     (pair, image row) by default, threads along W (a tuning plan's
//     row_tile x pair_tile rows a block, the kernel's tiled form, give the
//     same bits); `slot` is a runtime argument and
//     only that slot's (N/2, H, W) frame is written, the other K-1 are never
//     touched (the TPU kernel aliases the donated window for the same
//     reason);
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

template <int FMT, typename A>
cudaError_t launch_insert(const void* frames, void* slot, int64_t pairs,
                          int height, int items, int64_t row_bytes, int rt, int pt, bool tiled,
                          float offset, float u8_scale, cudaStream_t stream) {
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
// (0 = 1) are the image rows and pairs a block covers.
int median_window_insert_launch(const void* frames, void* slot, int64_t pairs,
                                int64_t height, int64_t items,
                                int64_t row_bytes, int fmt, float offset,
                                float u8_scale, int64_t row_tile, int64_t pair_tile,
                                int acc, void* stream) {
  const int64_t rows = pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t rt = row_tile ? row_tile : 1, pt = pair_tile ? pair_tile : 1;
  if (row_tile < 0 || pair_tile < 0 || !row_tiles_ok(pairs, height, rt, pt))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  const int r = static_cast<int>(rt), q = static_cast<int>(pt);
  const bool tiled = row_tile != 0 || pair_tile != 0;
  return on_window_type(acc, [&](auto zero) {
    using A = decltype(zero);
#define INSERT(F) launch_insert<F, A>(frames, slot, pairs, h, it, row_bytes, r, q, tiled, \
                                      offset, u8_scale, s)
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
