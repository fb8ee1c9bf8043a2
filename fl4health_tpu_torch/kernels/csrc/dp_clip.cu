// DP-SGD clip-and-reduce for Hopper (sm_90a): per-example squared norms and
// the scaled masked sum over examples.
//
// Replaces the two Pallas kernels of fl4health_tpu/kernels/dp_clip.py:
//   sq_norm_partial_kernel + sq_norm_finish_kernel <- _sq_norm_kernel    (K1)
//   scaled_sum_kernel                              <- _scaled_sum_kernel (K2)
//
// Both read one gradient leaf in place as a [B, W] matrix (row stride ld
// elements, unit column stride), f32 or bf16, and accumulate in f32. The TPU
// kernels pad W to 128-lane tiles; here the ragged edge is bounds-checked and
// nothing is copied.
//
// What bounds them on this card: memory. Each reads the B x W leaf once and
// does one or two flops per element read, far below the ~20 flops per byte the
// card sustains at 3.35 TB/s, so the bound is B*W*elem bytes over that rate.
// Loads are 16 bytes a thread (4 f32 or 8 bf16) where the leaf's base and row
// stride allow it, scalar otherwise.
//
// K1 reduces across columns, so across CTAs. The TPU kernel carries the sum in
// its output block over a sequential grid; CTAs here run in no order, so the
// reduction has two stages and no float atomics: stage 1 gives each
// (column chunk, row) CTA one f32 partial in a [B, n_chunks] workspace (a
// per-thread chain, then warp shuffles and shared memory in a fixed tree),
// stage 2 sums each row's partials in chunk order. The result is the same bit
// for bit from run to run.
//
// K2 reduces over B, which is small (the DP batch): each thread owns one 16-byte
// group of columns and loops over the B rows in order, so no CTA needs another's
// result and the clipped [B, W] tensor is never written. On a narrow leaf that
// leaves the card idle: a bias of 32 f32 columns is 8 threads, and each
// thread's time is a chain of B loads. There the wrapper asks for a row split
// (`split` > 1, a shape rule on W, B and the SM count, never a fallback):
// `split` threads share each column group, each sums its B / split rows in
// order, and the partials meet in shared memory in a fixed tree, so the
// result is still the same bit for bit from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int CHUNK = 8192;    // K1: columns per stage-1 CTA (a multiple of every pack)
constexpr int MAX_SPLIT = 32;  // K2: most threads that share one column group

// bf16 travels as its 16 bits; widening to f32 is a shift (exact).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

// The elements of one 16-byte load, widened to f32, in memory order.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);           // low half: the earlier element
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Sum over the CTA's NT threads in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = NT / 64; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// K1 stage 1: CTA (chunk, row) -> partial[row, chunk] = sum of g[row, c]^2 over
// the chunk's columns.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    sq_norm_partial_kernel(const T* __restrict__ g, int64_t ld, int64_t W,
                           float* __restrict__ partial) {
  constexpr int P = Pack<T>::N;
  const int chunk = blockIdx.x, row = blockIdx.y;
  const T* p = g + (int64_t)row * ld;
  const int64_t begin = (int64_t)chunk * CHUNK;
  const int64_t end = begin + CHUNK < W ? begin + CHUNK : W;
  float acc = 0.f;
  int64_t scalar_from = begin;
  if (VEC) {
    const int64_t n_packs = (end - begin) / P;
    const uint4* vp = reinterpret_cast<const uint4*>(p + begin);
    for (int64_t i = threadIdx.x; i < n_packs; i += NT) {
      float v[P];
      unpack(__ldg(vp + i), v);
#pragma unroll
      for (int k = 0; k < P; ++k) acc = fmaf(v[k], v[k], acc);
    }
    scalar_from = begin + n_packs * P;
  }
  for (int64_t c = scalar_from + threadIdx.x; c < end; c += NT) {
    const float v = to_f32(p[c]);
    acc = fmaf(v, v, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[(int64_t)row * gridDim.x + chunk] = acc;
}

// K1 stage 2: out[row] = the row's partials summed in chunk order.
__global__ void sq_norm_finish_kernel(const float* __restrict__ partial, int n_chunks, int B,
                                      float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* p = partial + (int64_t)row * n_chunks;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += p[c];
  out[row] = s;
}

// K2: out[c] = sum over rows i, in order, of scale[i] * g[i, c]. Thread t owns
// columns [t*P, t*P + P).
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    scaled_sum_kernel(const T* __restrict__ g, int64_t ld, int64_t W, int B,
                      const float* __restrict__ scale, float* __restrict__ out) {
  constexpr int P = Pack<T>::N;
  const int64_t c0 = ((int64_t)blockIdx.x * NT + threadIdx.x) * P;
  if (c0 >= W) return;
  float acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = 0.f;
  if (VEC && c0 + P <= W) {
#pragma unroll 4
    for (int i = 0; i < B; ++i) {
      const float s = __ldg(scale + i);
      float v[P];
      unpack(__ldg(reinterpret_cast<const uint4*>(g + (int64_t)i * ld + c0)), v);
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = fmaf(s, v[k], acc[k]);
    }
    float4* o = reinterpret_cast<float4*>(out + c0);  // c0 is a multiple of 4
#pragma unroll
    for (int k = 0; k < P / 4; ++k)
      o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
    return;
  }
  const int n = W - c0 < P ? (int)(W - c0) : P;
  for (int i = 0; i < B; ++i) {
    const float s = __ldg(scale + i);
    const T* row = g + (int64_t)i * ld + c0;
    for (int k = 0; k < n; ++k) acc[k] = fmaf(s, to_f32(row[k]), acc[k]);
  }
  for (int k = 0; k < n; ++k) out[c0 + k] = acc[k];
}

// K2 with its rows split: `split` (a power of two up to MAX_SPLIT) threads
// share each column group. Thread t is slice r = t / (NT / split) of group
// t % (NT / split) of the CTA's NT / split groups (neighbouring threads read
// neighbouring groups of one row), and sums rows [r * rows, (r + 1) * rows)
// in order, rows = ceil(B / split). Slice r + half adds into slice r, for
// half = split / 2, ..., 1: a fixed tree through shared memory.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    split_scaled_sum_kernel(const T* __restrict__ g, int64_t ld, int64_t W, int B,
                            const float* __restrict__ scale, float* __restrict__ out,
                            int split) {
  constexpr int P = Pack<T>::N;
  __shared__ float part[P][NT];  // [element][thread]: a warp's stores hit 32 banks
  const int groups = NT / split, r = threadIdx.x / groups;
  const int64_t c0 = ((int64_t)blockIdx.x * groups + threadIdx.x % groups) * P;
  const int rows = (B + split - 1) / split, i0 = r * rows, i1 = min(B, i0 + rows);
  float acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = 0.f;
  const int n = c0 >= W ? 0 : (W - c0 < P ? (int)(W - c0) : P);
  if (VEC && n == P) {
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const float s = __ldg(scale + i);
      float v[P];
      unpack(__ldg(reinterpret_cast<const uint4*>(g + (int64_t)i * ld + c0)), v);
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = fmaf(s, v[k], acc[k]);
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      const float s = __ldg(scale + i);
      const T* row = g + (int64_t)i * ld + c0;
#pragma unroll
      for (int k = 0; k < P; ++k)  // unrolled, so acc stays in registers
        if (k < n) acc[k] = fmaf(s, to_f32(row[k]), acc[k]);
    }
  }
  // every thread takes part in the tree, also one past W (its partial is 0)
#pragma unroll
  for (int k = 0; k < P; ++k) part[k][threadIdx.x] = acc[k];
  for (int half = split / 2; half > 0; half /= 2) {
    __syncthreads();
    if (r < half) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        acc[k] += part[k][threadIdx.x + half * groups];
        part[k][threadIdx.x] = acc[k];
      }
    }
  }
  if (r == 0)
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n) out[c0 + k] = acc[k];
}

// 16-byte loads need a 16-byte aligned base and a row stride that keeps every
// row aligned.
template <typename T>
bool vector_ok(const void* g, int64_t ld) {
  return reinterpret_cast<uintptr_t>(g) % 16 == 0 && (ld * (int64_t)sizeof(T)) % 16 == 0;
}

template <typename T>
int sq_norms_impl(const void* g_, int64_t ld, int64_t W, int B, float* partial, float* out,
                  cudaStream_t s) {
  const T* g = static_cast<const T*>(g_);
  const int n_chunks = (int)((W + CHUNK - 1) / CHUNK);
  const dim3 grid(n_chunks, B);
  if (vector_ok<T>(g_, ld))
    sq_norm_partial_kernel<T, true><<<grid, NT, 0, s>>>(g, ld, W, partial);
  else
    sq_norm_partial_kernel<T, false><<<grid, NT, 0, s>>>(g, ld, W, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sq_norm_finish_kernel<<<(B + NT - 1) / NT, NT, 0, s>>>(partial, n_chunks, B, out);
  return (int)cudaGetLastError();
}

template <typename T>
int scaled_sum_impl(const void* g_, int64_t ld, int64_t W, int B, const float* scale, float* out,
                    int split, cudaStream_t s) {
  const T* g = static_cast<const T*>(g_);
  constexpr int P = Pack<T>::N;
  const int64_t groups = (W + P - 1) / P;
  const bool vec = vector_ok<T>(g_, ld);
  if (split > 1) {
    const unsigned grid = (unsigned)((groups + NT / split - 1) / (NT / split));
    if (vec)
      split_scaled_sum_kernel<T, true><<<grid, NT, 0, s>>>(g, ld, W, B, scale, out, split);
    else
      split_scaled_sum_kernel<T, false><<<grid, NT, 0, s>>>(g, ld, W, B, scale, out, split);
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((groups + NT - 1) / NT);
  if (vec)
    scaled_sum_kernel<T, true><<<grid, NT, 0, s>>>(g, ld, W, B, scale, out);
  else
    scaled_sum_kernel<T, false><<<grid, NT, 0, s>>>(g, ld, W, B, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dp_chunk_width() { return CHUNK; }

// g: [B, W] with row stride ld; partial: [B, ceil(W / CHUNK)] f32 scratch;
// out: [B] f32.
int dp_sq_norms(const void* g, int64_t ld, int64_t W, int B, float* partial, float* out,
                int bf16, void* stream) {
  if (B <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? sq_norms_impl<uint16_t>(g, ld, W, B, partial, out, s)
              : sq_norms_impl<float>(g, ld, W, B, partial, out, s);
}

// g: [B, W] with row stride ld; scale: [B] f32; out: [W] f32; split: threads
// that share a column group, a power of two from 1 to MAX_SPLIT.
int dp_scaled_sum(const void* g, int64_t ld, int64_t W, int B, const float* scale, float* out,
                  int split, int bf16, void* stream) {
  if (B <= 0 || W <= 0 || split < 1 || split > MAX_SPLIT || (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? scaled_sum_impl<uint16_t>(g, ld, W, B, scale, out, split, s)
              : scaled_sum_impl<float>(g, ld, W, B, scale, out, split, s);
}

const char* dp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
