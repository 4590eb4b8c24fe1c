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
//   * vector path, for u16 and u8 where every plane allows it (H * W a
//     multiple of 8, the frames aligned to the width of their vector load,
//     the sum to 16 bytes): a pair's control plane frames[2p], excitation
//     plane frames[2p + 1] and sum plane sum[p] are each one contiguous run
//     of H * W pixels, read as 8-pixel vectors (u16: one 16-byte load per
//     frame, u8: one 8-byte load; the sum: two float4 loads and stores). Each
//     thread takes two vectors of a plane and issues all their loads before
//     it computes, so four wire loads and four sum loads (up to 128 bytes)
//     are in flight per thread. The grid is (vectors / 512, pairs): no division in the
//     index, and at the paper's shape 2,500 blocks of 256 threads. (The
//     scalar body below keeps one 2- to 4-byte load per thread in flight, in
//     40,000 one-row blocks at that shape: too few bytes in flight to cover
//     HBM latency, 68-70 % of the byte bound on the H100.)
//   * scalar path, on every other shape (a ragged plane, an unaligned view)
//     and for p12, whose 12-byte vector no single load takes (a warp-wide
//     load handed round through shared memory gained about 2 % on the H100,
//     within the spread between runs):
//     one thread per output pixel (per pixel pair for p12, whose 3 wire bytes
//     hold two pixels), one block per output row (pair, image row), threads
//     along W so that a warp's loads and stores are contiguous (coalesced).
//     It is part of the contract, not a fallback: the host sends only shapes
//     the vector path cannot take here.
// The one-shot forms (B3/B5) keep the scalar layout and loop over the G
// groups inside the thread, keeping the sum in a register: this replaces the
// TPU's sequential innermost grid axis, whose VMEM-resident accumulator has
// no counterpart across blocks; their G independent loads per thread already
// give them the memory-level parallelism the step lacked. The bank axis is
// one more index folded into the pair axis, so banks never touch each
// other's data, as on the TPU grid.
//
// Launch geometry is a tuning plan's (repro_torch/tune): `row_tile` image rows
// of `pair_tile` pairs a block on the scalar layout (for_tile_rows, quant.cuh),
// and on the vector path a share of row_tile x W pixels a block, in whole
// vectors, over pair_tile pairs. With no plan (0 from the host) each kernel
// runs its untiled form, the layouts above, unchanged. A geometry moves work
// between blocks and never changes a pixel's arithmetic: both forms run one
// row body, so every geometry gives the same bits.
//
// Integer sums (int32, or uint16 wrapping at 16 bits: the paper's u16-container
// overflow past G = 8) take u16 wire and one layout, the scalar one, in kernels
// of their own: they are the reference's contract, not its speed path. Their
// arithmetic is IntSum's (quant.cuh): the pair difference in int32, narrowed to
// the sum type; the divide-first fold adds floor(d / G); the final division
// floors.
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
template <int FMT, bool DIVIDE_FIRST>
__device__ __forceinline__ void step_row(const uint8_t* __restrict__ frames,
                                         float* __restrict__ sum, int64_t p, int64_t h,
                                         int height, int items, int64_t row_bytes,
                                         float offset, float u8_scale, float rcp,
                                         bool final_div) {
  constexpr int P = Item<FMT>::kPixels;
  const uint8_t* ctl = frames + ((2 * p) * height + h) * row_bytes;
  const uint8_t* exc = ctl + height * row_bytes;
  float* out = sum + (p * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    float d[P];
    pair_diff<FMT>(ctl, exc, x, offset, u8_scale, d);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float t = fold<DIVIDE_FIRST>(out[x * P + k], d[k], rcp);
      if constexpr (!DIVIDE_FIRST) {
        if (final_div) t = __fmul_rn(t, rcp);
      }
      out[x * P + k] = t;
    }
  }
}

template <int FMT, bool DIVIDE_FIRST, bool TILED>
__global__ void stream_step_kernel(const uint8_t* __restrict__ frames,
                                   float* __restrict__ sum, int64_t pairs, int height,
                                   int items, int64_t row_bytes, int rt, int pt, float offset,
                                   float u8_scale, float rcp, bool final_div) {
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      step_row<FMT, DIVIDE_FIRST>(frames, sum, p, h, height, items, row_bytes, offset,
                                  u8_scale, rcp, final_div);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    step_row<FMT, DIVIDE_FIRST>(frames, sum, p, r - p * height, height, items, row_bytes,
                                offset, u8_scale, rcp, final_div);
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
template <int FMT, bool DIVIDE_FIRST>
__device__ __forceinline__ void average_row(const uint8_t* __restrict__ frames,
                                            float* __restrict__ out, int64_t bp, int64_t h,
                                            int groups, int pairs, int height, int items,
                                            int64_t row_bytes, float offset, float u8_scale,
                                            float rcp) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t group_bytes = 2 * static_cast<int64_t>(pairs) * height * row_bytes;
  const uint8_t* base = frames + b * groups * group_bytes + ((2 * p) * height + h) * row_bytes;
  float* dst = out + (bp * height + h) * static_cast<int64_t>(items) * P;
  for (int x = threadIdx.x; x < items; x += blockDim.x) {
    float acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      const uint8_t* ctl = base + g * group_bytes;
      float d[P];
      pair_diff<FMT>(ctl, ctl + height * row_bytes, x, offset, u8_scale, d);
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = fold<DIVIDE_FIRST>(acc[k], d[k], rcp);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) dst[x * P + k] = DIVIDE_FIRST ? acc[k] : __fmul_rn(acc[k], rcp);
  }
}

template <int FMT, bool DIVIDE_FIRST, bool TILED>
__global__ void subtract_average_kernel(const uint8_t* __restrict__ frames,
                                        float* __restrict__ out, int64_t bank_pairs,
                                        int groups, int pairs, int height, int items,
                                        int64_t row_bytes, int rt, int pt, float offset,
                                        float u8_scale, float rcp) {
  if constexpr (TILED) {
    for_tile_rows(bank_pairs, height, rt, pt, [=](int64_t bp, int64_t h) {
      average_row<FMT, DIVIDE_FIRST>(frames, out, bp, h, groups, pairs, height, items,
                                     row_bytes, offset, u8_scale, rcp);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t bp = r / height;
    average_row<FMT, DIVIDE_FIRST>(frames, out, bp, r - bp * height, groups, pairs, height,
                                   items, row_bytes, offset, u8_scale, rcp);
  }
}

// B2/B4 and B3/B5 with an integer sum T (scalar layout, u16 wire): the step
// folds one group in place (rows as in stream_step_kernel); the one-shot keeps
// the sum in a register across the G groups (rows as in subtract_average_kernel).
template <typename T, bool DIVIDE_FIRST>
__device__ __forceinline__ void step_int_row(const uint16_t* __restrict__ frames,
                                             T* __restrict__ sum, int64_t p, int64_t h,
                                             int height, int width, int32_t offset,
                                             int32_t groups, bool final_div) {
  const uint16_t* ctl = frames + ((2 * p) * height + h) * width;
  const uint16_t* exc = ctl + static_cast<int64_t>(height) * width;
  T* out = sum + (p * height + h) * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    T d = int_pair_diff<T>(ctl[x], exc[x], offset);
    if constexpr (DIVIDE_FIRST) d = IntSum<T>::div(d, groups);
    T s = IntSum<T>::add(out[x], d);
    if constexpr (!DIVIDE_FIRST) {
      if (final_div) s = IntSum<T>::div(s, groups);
    }
    out[x] = s;
  }
}

template <typename T, bool DIVIDE_FIRST, bool TILED>
__global__ void stream_step_int_kernel(const uint16_t* __restrict__ frames,
                                       T* __restrict__ sum, int64_t pairs, int height,
                                       int width, int rt, int pt, int32_t offset,
                                       int32_t groups, bool final_div) {
  if constexpr (TILED) {
    for_tile_rows(pairs, height, rt, pt, [=](int64_t p, int64_t h) {
      step_int_row<T, DIVIDE_FIRST>(frames, sum, p, h, height, width, offset, groups,
                                    final_div);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t p = r / height;
    step_int_row<T, DIVIDE_FIRST>(frames, sum, p, r - p * height, height, width, offset,
                                  groups, final_div);
  }
}

template <typename T, bool DIVIDE_FIRST>
__device__ __forceinline__ void average_int_row(const uint16_t* __restrict__ frames,
                                                T* __restrict__ out, int64_t bp, int64_t h,
                                                int groups, int pairs, int height, int width,
                                                int32_t offset) {
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t group_px = 2 * static_cast<int64_t>(pairs) * plane;
  const uint16_t* base = frames + b * groups * group_px + (2 * p) * plane + h * width;
  T* dst = out + (bp * height + h) * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    T acc = 0;
    for (int g = 0; g < groups; ++g) {
      const uint16_t* ctl = base + g * group_px;
      T d = int_pair_diff<T>(ctl[x], ctl[plane + x], offset);
      if constexpr (DIVIDE_FIRST) d = IntSum<T>::div(d, groups);
      acc = IntSum<T>::add(acc, d);
    }
    dst[x] = DIVIDE_FIRST ? acc : IntSum<T>::div(acc, groups);
  }
}

template <typename T, bool DIVIDE_FIRST, bool TILED>
__global__ void subtract_average_int_kernel(const uint16_t* __restrict__ frames,
                                            T* __restrict__ out, int64_t bank_pairs,
                                            int groups, int pairs, int height, int width,
                                            int rt, int pt, int32_t offset) {
  if constexpr (TILED) {
    for_tile_rows(bank_pairs, height, rt, pt, [=](int64_t bp, int64_t h) {
      average_int_row<T, DIVIDE_FIRST>(frames, out, bp, h, groups, pairs, height, width,
                                       offset);
    });
  } else {
    const int64_t r = blockIdx.x;
    const int64_t bp = r / height;
    average_int_row<T, DIVIDE_FIRST>(frames, out, bp, r - bp * height, groups, pairs, height,
                                     width, offset);
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

template <typename T>
cudaError_t launch_step_int(const void* frames, void* sum, int64_t pairs, int height,
                            int width, Tiles t, int32_t offset, int32_t groups,
                            bool divide_first, bool final_div, cudaStream_t stream) {
  const unsigned blocks = t.blocks(pairs, height);
  const int threads = threads_for(width);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
  T* s = static_cast<T*>(sum);
  return in_form(t.tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if (divide_first) {
      stream_step_int_kernel<T, true, kTiled><<<blocks, threads, 0, stream>>>(
          f, s, pairs, height, width, t.rt, t.pt, offset, groups, final_div);
    } else {
      stream_step_int_kernel<T, false, kTiled><<<blocks, threads, 0, stream>>>(
          f, s, pairs, height, width, t.rt, t.pt, offset, groups, final_div);
    }
  });
}

template <typename T>
cudaError_t launch_oneshot_int(const void* frames, void* out, int64_t bank_pairs, int groups,
                               int pairs, int height, int width, Tiles t, int32_t offset,
                               bool divide_first, cudaStream_t stream) {
  const unsigned blocks = t.blocks(bank_pairs, height);
  const int threads = threads_for(width);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
  T* o = static_cast<T*>(out);
  return in_form(t.tiled, [&](auto form) {
    constexpr bool kTiled = decltype(form)::value;
    if (divide_first) {
      subtract_average_int_kernel<T, true, kTiled><<<blocks, threads, 0, stream>>>(
          f, o, bank_pairs, groups, pairs, height, width, t.rt, t.pt, offset);
    } else {
      subtract_average_int_kernel<T, false, kTiled><<<blocks, threads, 0, stream>>>(
          f, o, bank_pairs, groups, pairs, height, width, t.rt, t.pt, offset);
    }
  });
}

// The vector path's geometry: row_tile x items pixels a block, in whole
// vectors (512 vectors when row_tile is 0), and pt pairs a block.
template <int FMT, bool DF>
cudaError_t launch_step(const void* frames, void* sum, int64_t pairs, int height,
                        int items, int64_t row_bytes, int64_t row_tile, Tiles t, float offset,
                        float u8_scale, float rcp, bool final_div, bool vector,
                        cudaStream_t stream) {
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  float* s = static_cast<float*>(sum);
  if constexpr (FMT != kP12) {
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
    stream_step_kernel<FMT, DF, decltype(form)::value>
        <<<t.blocks(pairs, height), threads_for(items), 0, stream>>>(
            f, s, pairs, height, items, row_bytes, t.rt, t.pt, offset, u8_scale, rcp,
            final_div);
  });
}

// Alignment (bytes) of a plane start that the vector path's loads need.
int vector_align(int fmt) { return fmt == kU16 ? 16 : 8; }

template <int FMT, bool DF>
cudaError_t launch_oneshot(const void* frames, void* out, int64_t bank_pairs,
                           int groups, int pairs, int height, int items,
                           int64_t row_bytes, Tiles t, float offset, float u8_scale,
                           float rcp, cudaStream_t stream) {
  return in_form(t.tiled, [&](auto form) {
    subtract_average_kernel<FMT, DF, decltype(form)::value>
        <<<t.blocks(bank_pairs, height), threads_for(items), 0, stream>>>(
            static_cast<const uint8_t*>(frames), static_cast<float*>(out), bank_pairs, groups,
            pairs, height, items, row_bytes, t.rt, t.pt, offset, u8_scale, rcp);
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

int step(const void* frames, void* sum, int64_t pairs, int64_t height,
         int64_t items, int64_t row_bytes, int fmt, int divide_first,
         int final_div, int vector, float offset, float u8_scale, float rcp,
         int acc, int64_t groups, int64_t row_tile, int64_t pair_tile, void* stream) {
  const int64_t rows = pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff) return cudaErrorInvalidValue;
  if (fmt < kU16 || fmt > kP12) return cudaErrorInvalidValue;
  Tiles t;
  if (!tiles_for(pairs, height, row_tile, pair_tile, &t)) return cudaErrorInvalidValue;
  if (acc != kAccF32) {  // integer sums: u16 wire, the scalar layout only
    if (fmt != kU16 || vector || groups < 1 || groups > 0x7fffffff) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int h = static_cast<int>(height), w = static_cast<int>(items);
    const int32_t off = static_cast<int32_t>(offset), g = static_cast<int32_t>(groups);
    if (acc == kAccI32)
      return launch_step_int<int32_t>(frames, sum, pairs, h, w, t, off, g, divide_first,
                                      final_div, s);
    if (acc == kAccU16)
      return launch_step_int<uint16_t>(frames, sum, pairs, h, w, t, off, g, divide_first,
                                       final_div, s);
    return cudaErrorInvalidValue;
  }
  // the host chose the vector path; a shape it cannot take is refused, never rerouted
  if (vector && (fmt == kP12 || (height * items) % 8 ||
                 reinterpret_cast<uintptr_t>(frames) % vector_align(fmt) ||
                 reinterpret_cast<uintptr_t>(sum) % 16))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  const bool fd = final_div != 0, vec = vector != 0;
#define STEP(F, D) \
  launch_step<F, D>(frames, sum, pairs, h, it, row_bytes, row_tile, t, offset, u8_scale, rcp, \
                    fd, vec, s)
  switch (fmt) {
    case kU16: return divide_first ? STEP(kU16, true) : STEP(kU16, false);
    case kU8: return divide_first ? STEP(kU8, true) : STEP(kU8, false);
    case kP12: return divide_first ? STEP(kP12, true) : STEP(kP12, false);
  }
#undef STEP
  return cudaErrorInvalidValue;
}

int oneshot(const void* frames, void* out, int64_t banks, int64_t groups,
            int64_t pairs, int64_t height, int64_t items, int64_t row_bytes,
            int fmt, int divide_first, float offset, float u8_scale, float rcp,
            int acc, int64_t row_tile, int64_t pair_tile, void* stream) {
  const int64_t rows = banks * pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff || groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  Tiles t;
  if (!tiles_for(banks * pairs, height, row_tile, pair_tile, &t)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups), p = static_cast<int>(pairs);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  const int64_t bp = banks * pairs;
  if (acc != kAccF32) {  // integer sums: u16 wire only
    if (fmt != kU16 || groups < 1) return cudaErrorInvalidValue;
    const int32_t off = static_cast<int32_t>(offset);
    if (acc == kAccI32)
      return launch_oneshot_int<int32_t>(frames, out, bp, g, p, h, it, t, off, divide_first, s);
    if (acc == kAccU16)
      return launch_oneshot_int<uint16_t>(frames, out, bp, g, p, h, it, t, off, divide_first, s);
    return cudaErrorInvalidValue;
  }
#define ONESHOT(F, D) \
  launch_oneshot<F, D>(frames, out, bp, g, p, h, it, row_bytes, t, offset, u8_scale, rcp, s)
  switch (fmt) {
    case kU16: return divide_first ? ONESHOT(kU16, true) : ONESHOT(kU16, false);
    case kU8: return divide_first ? ONESHOT(kU8, true) : ONESHOT(kU8, false);
    case kP12: return divide_first ? ONESHOT(kP12, true) : ONESHOT(kP12, false);
  }
#undef ONESHOT
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, one per TPU kernel, loaded with ctypes. Each returns
// the cudaError_t of its launch (0 = launched). `items` is the number of
// thread items per output row: W, or W/2 for p12. `row_bytes` is the wire
// row length in bytes. `row_tile` and `pair_tile` (0 = the default geometry)
// set the image rows and pairs a block covers: on a step's vector path a
// block's share is row_tile x items pixels in whole vectors (512 vectors by
// default); a launch the grid cannot hold returns cudaErrorInvalidValue. A
// step's `vector` flag selects the vector path; the host sets it only where
// the planes allow it (denoise_stream.step_path), and
// a launch that asks for it on planes that do not returns
// cudaErrorMisalignedAddress. `acc` is the sum's AccumCode (quant.cuh): an
// integer sum takes u16 wire and the scalar layout (else
// cudaErrorInvalidValue), and a step's `groups` is G.
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
                                 int64_t row_bytes, int fmt, int divide_first,
                                 float offset, float u8_scale, float rcp, int acc,
                                 int64_t row_tile, int64_t pair_tile, void* stream) {
  return oneshot(frames, out, 1, groups, pairs, height, items, row_bytes, fmt,
                 divide_first, offset, u8_scale, rcp, acc, row_tile, pair_tile, stream);
}

int multibank_subtract_average_launch(const void* frames, void* out,
                                      int64_t banks, int64_t groups,
                                      int64_t pairs, int64_t height,
                                      int64_t items, int64_t row_bytes,
                                      int fmt, int divide_first, float offset,
                                      float u8_scale, float rcp, int acc,
                                      int64_t row_tile, int64_t pair_tile, void* stream) {
  return oneshot(frames, out, banks, groups, pairs, height, items, row_bytes,
                 fmt, divide_first, offset, u8_scale, rcp, acc, row_tile, pair_tile, stream);
}

}  // extern "C"
