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

// B2/B4, scalar path: fold one group into the running sum, in place. Row r is
// (pair p, image row h) over all banks: a (B, N, H, wire) group is the same
// memory as (B*N, H, wire), so the bank axis folds into the pair axis.
template <int FMT, bool DIVIDE_FIRST>
__global__ void stream_step_kernel(const uint8_t* __restrict__ frames,
                                   float* __restrict__ sum, int height,
                                   int items, int64_t row_bytes, float offset,
                                   float u8_scale, float rcp, bool final_div) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t r = blockIdx.x;
  const int64_t p = r / height;
  const int64_t h = r - p * height;
  const uint8_t* ctl = frames + ((2 * p) * height + h) * row_bytes;
  const uint8_t* exc = ctl + height * row_bytes;
  float* out = sum + r * static_cast<int64_t>(items) * P;
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

// B2/B4, vector path (u16, u8): block (x, y) takes vectors [512x, 512x + 512)
// of the planes of pair y (and of y + gridDim.y, ... when there are more pairs
// than a grid row holds); thread i takes vectors 512x + i and 512x + 256 + i.
constexpr int kVecThreads = 256;
constexpr int kVecPerThread = 2;
constexpr int kVecPerBlock = kVecThreads * kVecPerThread;

template <int FMT, bool DIVIDE_FIRST>
__global__ void __launch_bounds__(kVecThreads)
    stream_step_vec_kernel(const uint8_t* __restrict__ frames, float* __restrict__ sum,
                           int64_t pairs, int64_t vectors, int64_t plane_bytes,
                           float offset, float u8_scale, float rcp, bool final_div) {
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kVecPerBlock + threadIdx.x;
  for (int64_t p = blockIdx.y; p < pairs; p += gridDim.y) {
    const uint8_t* ctl = frames + 2 * p * plane_bytes;
    const uint8_t* exc = ctl + plane_bytes;
    float4* out = reinterpret_cast<float4*>(sum) + p * vectors * 2;
    Wire8<FMT> c[kVecPerThread], e[kVecPerThread];
    float4 lo[kVecPerThread], hi[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {  // every load before any use
      const int64_t v = v0 + u * kVecThreads;
      if (v < vectors) {
        c[u] = load8<FMT>(ctl, v);
        e[u] = load8<FMT>(exc, v);
        lo[u] = out[2 * v];
        hi[u] = out[2 * v + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const int64_t v = v0 + u * kVecThreads;
      if (v < vectors) {
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
}

// B3/B5: one-shot average over G groups. Row r is (bank b, pair p, row h);
// the sum of one output pixel stays in registers across the group loop.
template <int FMT, bool DIVIDE_FIRST>
__global__ void subtract_average_kernel(const uint8_t* __restrict__ frames,
                                        float* __restrict__ out, int groups,
                                        int pairs, int height, int items,
                                        int64_t row_bytes, float offset,
                                        float u8_scale, float rcp) {
  constexpr int P = Item<FMT>::kPixels;
  const int64_t r = blockIdx.x;
  const int64_t bp = r / height;
  const int64_t h = r - bp * height;
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t group_bytes = 2 * static_cast<int64_t>(pairs) * height * row_bytes;
  const uint8_t* base =
      frames + b * groups * group_bytes + ((2 * p) * height + h) * row_bytes;
  float* dst = out + r * static_cast<int64_t>(items) * P;
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
    for (int k = 0; k < P; ++k)
      dst[x * P + k] = DIVIDE_FIRST ? acc[k] : __fmul_rn(acc[k], rcp);
  }
}

// B2/B4 and B3/B5 with an integer sum T (scalar layout, u16 wire): the step
// folds one group in place (row r = (pair p, image row h) as above); the
// one-shot keeps the sum in a register across the G groups.
template <typename T, bool DIVIDE_FIRST>
__global__ void stream_step_int_kernel(const uint16_t* __restrict__ frames,
                                       T* __restrict__ sum, int height, int width,
                                       int32_t offset, int32_t groups, bool final_div) {
  const int64_t r = blockIdx.x;
  const int64_t p = r / height;
  const int64_t h = r - p * height;
  const uint16_t* ctl = frames + ((2 * p) * height + h) * width;
  const uint16_t* exc = ctl + static_cast<int64_t>(height) * width;
  T* out = sum + r * width;
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

template <typename T, bool DIVIDE_FIRST>
__global__ void subtract_average_int_kernel(const uint16_t* __restrict__ frames,
                                            T* __restrict__ out, int groups, int pairs,
                                            int height, int width, int32_t offset) {
  const int64_t r = blockIdx.x;
  const int64_t bp = r / height;
  const int64_t h = r - bp * height;
  const int64_t b = bp / pairs;
  const int64_t p = bp - b * pairs;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t group_px = 2 * static_cast<int64_t>(pairs) * plane;
  const uint16_t* base = frames + b * groups * group_px + (2 * p) * plane + h * width;
  T* dst = out + r * width;
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

template <typename T>
cudaError_t launch_step_int(const void* frames, void* sum, int64_t rows, int height,
                            int width, int32_t offset, int32_t groups, bool divide_first,
                            bool final_div, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(rows);
  const int t = threads_for(width);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
  T* s = static_cast<T*>(sum);
  if (divide_first) {
    stream_step_int_kernel<T, true><<<blocks, t, 0, stream>>>(f, s, height, width, offset,
                                                               groups, final_div);
  } else {
    stream_step_int_kernel<T, false><<<blocks, t, 0, stream>>>(f, s, height, width, offset,
                                                                groups, final_div);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_oneshot_int(const void* frames, void* out, int64_t rows, int groups,
                               int pairs, int height, int width, int32_t offset,
                               bool divide_first, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(rows);
  const int t = threads_for(width);
  const uint16_t* f = static_cast<const uint16_t*>(frames);
  T* o = static_cast<T*>(out);
  if (divide_first) {
    subtract_average_int_kernel<T, true><<<blocks, t, 0, stream>>>(f, o, groups, pairs, height,
                                                                    width, offset);
  } else {
    subtract_average_int_kernel<T, false><<<blocks, t, 0, stream>>>(f, o, groups, pairs, height,
                                                                     width, offset);
  }
  return cudaGetLastError();
}

template <int FMT, bool DF>
cudaError_t launch_step(const void* frames, void* sum, int64_t pairs, int height,
                        int items, int64_t row_bytes, float offset,
                        float u8_scale, float rcp, bool final_div, bool vector,
                        cudaStream_t stream) {
  if constexpr (FMT != kP12) {
    if (vector) {
      const int64_t vectors = static_cast<int64_t>(height) * items / 8;
      const dim3 grid(static_cast<unsigned>((vectors + kVecPerBlock - 1) / kVecPerBlock),
                      static_cast<unsigned>(pairs < 65535 ? pairs : 65535));
      stream_step_vec_kernel<FMT, DF><<<grid, kVecThreads, 0, stream>>>(
          static_cast<const uint8_t*>(frames), static_cast<float*>(sum), pairs, vectors,
          height * row_bytes, offset, u8_scale, rcp, final_div);
      return cudaGetLastError();
    }
  }
  stream_step_kernel<FMT, DF><<<static_cast<unsigned>(pairs * height), threads_for(items), 0,
                                stream>>>(
      static_cast<const uint8_t*>(frames), static_cast<float*>(sum), height, items,
      row_bytes, offset, u8_scale, rcp, final_div);
  return cudaGetLastError();
}

// Alignment (bytes) of a plane start that the vector path's loads need.
int vector_align(int fmt) { return fmt == kU16 ? 16 : 8; }

template <int FMT, bool DF>
cudaError_t launch_oneshot(const void* frames, void* out, int64_t rows,
                           int groups, int pairs, int height, int items,
                           int64_t row_bytes, float offset, float u8_scale,
                           float rcp, cudaStream_t stream) {
  subtract_average_kernel<FMT, DF><<<static_cast<unsigned>(rows), threads_for(items), 0, stream>>>(
      static_cast<const uint8_t*>(frames), static_cast<float*>(out), groups,
      pairs, height, items, row_bytes, offset, u8_scale, rcp);
  return cudaGetLastError();
}

int step(const void* frames, void* sum, int64_t pairs, int64_t height,
         int64_t items, int64_t row_bytes, int fmt, int divide_first,
         int final_div, int vector, float offset, float u8_scale, float rcp,
         int acc, int64_t groups, void* stream) {
  const int64_t rows = pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff) return cudaErrorInvalidValue;
  if (fmt < kU16 || fmt > kP12) return cudaErrorInvalidValue;
  if (acc != kAccF32) {  // integer sums: u16 wire, the scalar layout only
    if (fmt != kU16 || vector || groups < 1 || groups > 0x7fffffff) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int h = static_cast<int>(height), w = static_cast<int>(items);
    const int32_t off = static_cast<int32_t>(offset), g = static_cast<int32_t>(groups);
    if (acc == kAccI32)
      return launch_step_int<int32_t>(frames, sum, rows, h, w, off, g, divide_first, final_div, s);
    if (acc == kAccU16)
      return launch_step_int<uint16_t>(frames, sum, rows, h, w, off, g, divide_first, final_div, s);
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
#define STEP(F, D) launch_step<F, D>(frames, sum, pairs, h, it, row_bytes, offset, u8_scale, rcp, fd, vec, s)
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
            int acc, void* stream) {
  const int64_t rows = banks * pairs * height;
  if (rows == 0 || items == 0) return cudaSuccess;
  if (rows > 0x7fffffff || items > 0x7fffffff || groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups), p = static_cast<int>(pairs);
  const int h = static_cast<int>(height), it = static_cast<int>(items);
  if (acc != kAccF32) {  // integer sums: u16 wire only
    if (fmt != kU16 || groups < 1) return cudaErrorInvalidValue;
    const int32_t off = static_cast<int32_t>(offset);
    if (acc == kAccI32)
      return launch_oneshot_int<int32_t>(frames, out, rows, g, p, h, it, off, divide_first, s);
    if (acc == kAccU16)
      return launch_oneshot_int<uint16_t>(frames, out, rows, g, p, h, it, off, divide_first, s);
    return cudaErrorInvalidValue;
  }
#define ONESHOT(F, D) launch_oneshot<F, D>(frames, out, rows, g, p, h, it, row_bytes, offset, u8_scale, rcp, s)
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
// row length in bytes. A step's `vector` flag selects the vector path; the
// host sets it only where the planes allow it (denoise_stream.step_path), and
// a launch that asks for it on planes that do not returns
// cudaErrorMisalignedAddress. `acc` is the sum's AccumCode (quant.cuh): an
// integer sum takes u16 wire and the scalar layout (else
// cudaErrorInvalidValue), and a step's `groups` is G.
extern "C" {

int alg3_stream_step_launch(const void* frames, void* sum, int64_t pairs,
                            int64_t height, int64_t items, int64_t row_bytes,
                            int fmt, int divide_first, int final_div,
                            int vector, float offset, float u8_scale, float rcp,
                            int acc, int64_t groups, void* stream) {
  return step(frames, sum, pairs, height, items, row_bytes, fmt, divide_first,
              final_div, vector, offset, u8_scale, rcp, acc, groups, stream);
}

int multibank_stream_step_launch(const void* frames, void* sum, int64_t banks,
                                 int64_t pairs, int64_t height, int64_t items,
                                 int64_t row_bytes, int fmt, int divide_first,
                                 int final_div, int vector, float offset,
                                 float u8_scale, float rcp, int acc, int64_t groups,
                                 void* stream) {
  return step(frames, sum, banks * pairs, height, items, row_bytes, fmt,
              divide_first, final_div, vector, offset, u8_scale, rcp, acc, groups,
              stream);
}

int alg3_subtract_average_launch(const void* frames, void* out, int64_t groups,
                                 int64_t pairs, int64_t height, int64_t items,
                                 int64_t row_bytes, int fmt, int divide_first,
                                 float offset, float u8_scale, float rcp, int acc,
                                 void* stream) {
  return oneshot(frames, out, 1, groups, pairs, height, items, row_bytes, fmt,
                 divide_first, offset, u8_scale, rcp, acc, stream);
}

int multibank_subtract_average_launch(const void* frames, void* out,
                                      int64_t banks, int64_t groups,
                                      int64_t pairs, int64_t height,
                                      int64_t items, int64_t row_bytes,
                                      int fmt, int divide_first, float offset,
                                      float u8_scale, float rcp, int acc, void* stream) {
  return oneshot(frames, out, banks, groups, pairs, height, items, row_bytes,
                 fmt, divide_first, offset, u8_scale, rcp, acc, stream);
}

}  // extern "C"
