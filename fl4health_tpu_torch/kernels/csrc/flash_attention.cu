// Flash attention for Hopper (sm_90a) on the CUDA cores: forward, dQ and
// dK/dV kernels.
//
// Replaces the three Pallas kernels of fl4health_tpu/kernels/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel     (online-softmax forward, writes O and lse)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (dQ over query tiles, P recomputed from lse)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (dK and dV over key tiles)
// for f32 inputs (IEEE f32, as Precision.HIGHEST demands) and for bf16 inputs
// outside the tensor-core route. bf16 with a head dim the route takes (d <= 64,
// 2d a multiple of 16 bytes) runs the three kernels of flash_attention_wgmma.cu
// instead.
//
// Layout: q, k, v, o, dout, dq, dk, dv are [B, T, H, D] (row stride H*d), so the
// wrapper needs no transpose; mask is [B, T] f32 (1 = real key); lse and delta
// are [B, H, T] f32. Ragged T is handled by bounds checks, and any head dim
// d <= 64 by zero-filling shared memory up to the template width D = 64 (the
// head dim of every configuration this port runs).
//
// What bounds them on this card: at T = 2048 each is compute-bound (about 4*T*D
// operations per 2*D loaded elements of a row). This first version does every
// product as an IEEE f32 FMA on the CUDA cores (the JAX kernel forces
// Precision.HIGHEST for f32, so TF32 is not allowed; bf16 inputs are widened to
// f32 on load), so its ceiling is the card's f32 rate, not the tensor cores.
// The design keeps what the TPU kernel keeps out of device memory: the T x T
// scores never leave shared memory. Each CTA holds a 64-row tile and loops over
// 64-row tiles of the other operand staged in shared memory; 256 threads form a
// 16 x 16 grid and each owns a 4 x 4 register micro-tile of every 64 x 64
// product (rows ty + 16 i, columns tx + 16 j, so a row lives in one half-warp
// and its softmax statistics reduce with four shuffles). Key tiles whose keys
// are all padding are skipped: their probabilities are exactly 0, so the
// result is the same as computing them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename scalar_t>
__device__ __forceinline__ scalar_t from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of one (batch, head) into a [64][D + 1] f32 tile,
// times `scale`; rows past seqlen and columns past d read as 0.
template <typename scalar_t, int D>
__device__ __forceinline__ void load_tile(float* dst, const scalar_t* __restrict__ src, int row0,
                                          int seqlen, int d, int rs, float scale) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D, t = row0 + r;
    float x = 0.f;
    if (t < seqlen && c < d) x = to_f32(src[(size_t)t * rs + c]) * scale;
    dst[r * DP + c] = x;
  }
}

// Per-row f32 vector ([B, H, T] layout) for rows [row0, row0 + 64); 0 past seqlen.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int seqlen) {
  if (threadIdx.x < 64) {
    const int t = row0 + threadIdx.x;
    dst[threadIdx.x] = t < seqlen ? src[t] : 0.f;
  }
}

// Key validity of [k0, k0 + 64) into shared memory; true (for every thread)
// when at least one key of the tile is real.
__device__ __forceinline__ bool load_key_mask(float* dst, const float* __restrict__ mrow, int k0,
                                              int seqlen) {
  bool any = false;
  if (threadIdx.x < BK) {
    const int t = k0 + threadIdx.x;
    const float mv = t < seqlen ? mrow[t] : 0.f;
    dst[threadIdx.x] = mv;
    any = mv > 0.f;
  }
  return __syncthreads_or(any) != 0;
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                 const scalar_t* __restrict__ v, const float* __restrict__ mask,
                 scalar_t* __restrict__ o, float* __restrict__ lse, int seqlen, int H, int d,
                 float scale) {
  constexpr int DP = D + 1, PP = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][DP], pre-scaled as in the JAX kernel
  float* Ks = Qs + BQ * DP;    // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][DP]
  float* Ps = Vs + BK * DP;    // [BQ][PP]
  float* Ms = Ps + BQ * PP;    // [BK]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int rs = H * d;
  const size_t base = (size_t)b * seqlen * rs + (size_t)h * d;
  const float* mrow = mask + (size_t)b * seqlen;

  load_tile<scalar_t, D>(Qs, q + base, q0, seqlen, d, rs, scale);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seqlen; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps, Ms
    if (!load_key_mask(Ms, mrow, k0, seqlen)) continue;
    load_tile<scalar_t, D>(Ks, k + base, k0, seqlen, d, rs, 1.f);
    load_tile<scalar_t, D>(Vs, v + base, k0, seqlen, d, rs, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!(Ms[tx + 16 * j] > 0.f)) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = Ms[tx + 16 * j] > 0.f ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seqlen) continue;
    // a row with no real key keeps l = 0: O = 0 and lse = -1e30 + log(1e-20), finite
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) o[base + (size_t)t * rs + col] = from_f32<scalar_t>(acc[i][j] / denom);
    }
    if (tx == 0) lse[(size_t)bh * seqlen + t] = m[i] + logf(denom);
  }
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                    const scalar_t* __restrict__ v, const float* __restrict__ mask,
                    const scalar_t* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, scalar_t* __restrict__ dq, int seqlen, int H,
                    int d, float scale) {
  constexpr int DP = D + 1, PP = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Ks = dOs + BQ * DP;    // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* dSs = Vs + BK * DP;    // [BQ][PP]
  float* Ms = dSs + BQ * PP;    // [BK]
  float* Ls = Ms + BK;          // [BQ]
  float* Dl = Ls + BQ;          // [BQ]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int rs = H * d;
  const size_t base = (size_t)b * seqlen * rs + (size_t)h * d;
  const float* mrow = mask + (size_t)b * seqlen;

  load_tile<scalar_t, D>(Qs, q + base, q0, seqlen, d, rs, 1.f);
  load_tile<scalar_t, D>(dOs, dout + base, q0, seqlen, d, rs, 1.f);
  load_rows(Ls, lse + (size_t)bh * seqlen, q0, seqlen);
  load_rows(Dl, delta + (size_t)bh * seqlen, q0, seqlen);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seqlen; k0 += BK) {
    __syncthreads();
    if (!load_key_mask(Ms, mrow, k0, seqlen)) continue;
    load_tile<scalar_t, D>(Ks, k + base, k0, seqlen, d, rs, 1.f);
    load_tile<scalar_t, D>(Vs, v + base, k0, seqlen, d, rs, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], g[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * DP + kk];
        g[i] = dOs[(ty + 16 * i) * DP + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * DP + kk];
        vb[j] = Vs[(tx + 16 * j) * DP + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lr = Ls[r], dr = Dl[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = Ms[c] > 0.f ? expf(s[i][j] * scale - lr) : 0.f;
        dSs[r * PP + c] = p * (dp[i][j] - dr) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seqlen) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dq[base + (size_t)t * rs + col] = from_f32<scalar_t>(acc[i][j]);
    }
  }
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                     const scalar_t* __restrict__ v, const float* __restrict__ mask,
                     const scalar_t* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, scalar_t* __restrict__ dk,
                     scalar_t* __restrict__ dv, int seqlen, int H, int d, float scale) {
  constexpr int DP = D + 1, PP = BQ + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* Qs = Vs + BK * DP;     // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Pt = dOs + BQ * DP;    // [BK][PP]: P transposed (keys x queries)
  float* dSt = Pt + BK * PP;    // [BK][PP]
  float* Ms = dSt + BK * PP;    // [BK]
  float* Ls = Ms + BK;          // [BQ]
  float* Dl = Ls + BQ;          // [BQ]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int rs = H * d;
  const size_t base = (size_t)b * seqlen * rs + (size_t)h * d;
  const float* mrow = mask + (size_t)b * seqlen;

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // a tile of padding keys has P = 0 for every query: dK = dV = 0
  if (load_key_mask(Ms, mrow, k0, seqlen)) {
    load_tile<scalar_t, D>(Ks, k + base, k0, seqlen, d, rs, 1.f);
    load_tile<scalar_t, D>(Vs, v + base, k0, seqlen, d, rs, 1.f);
    for (int q0 = 0; q0 < seqlen; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done with Qs, dOs, Pt, dSt
      load_tile<scalar_t, D>(Qs, q + base, q0, seqlen, d, rs, 1.f);
      load_tile<scalar_t, D>(dOs, dout + base, q0, seqlen, d, rs, 1.f);
      load_rows(Ls, lse + (size_t)bh * seqlen, q0, seqlen);
      load_rows(Dl, delta + (size_t)bh * seqlen, q0, seqlen);
      __syncthreads();

      // micro-tile rows are keys (ty + 16 i), columns are queries (tx + 16 j)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        float kb[4], vb[4], a[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kb[i] = Ks[(ty + 16 * i) * DP + kk];
          vb[i] = Vs[(ty + 16 * i) * DP + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = Qs[(tx + 16 * j) * DP + kk];
          g[j] = dOs[(tx + 16 * j) * DP + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kb[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vb[i], g[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
        const bool key_ok = Ms[c] > 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = (key_ok && q0 + r < seqlen) ? expf(s[i][j] * scale - Ls[r]) : 0.f;
          Pt[c * PP + r] = p;
          dSt[c * PP + r] = p * (dp[i][j] - Dl[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4], g[DJ], a[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Pt[(ty + 16 * i) * PP + r];
          ds[i] = dSt[(ty + 16 * i) * PP + r];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          g[j] = dOs[r * DP + tx + 16 * j];
          a[j] = Qs[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] = fmaf(p[i], g[j], adv[i][j]);
            adk[i][j] = fmaf(ds[i], a[j], adk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= seqlen) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        dk[base + (size_t)t * rs + col] = from_f32<scalar_t>(adk[i][j]);
        dv[base + (size_t)t * rs + col] = from_f32<scalar_t>(adv[i][j]);
      }
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (size_t)(3 * 64 * (D + 1) + BQ * (BK + 1) + BK);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1) + BK + 2 * BQ);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BK * (BQ + 1) + BK + 2 * BQ);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename scalar_t, int D>
int fwd_impl(const void* q, const void* k, const void* v, const float* mask, void* o, float* lse,
             int B, int T, int H, int d, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(flash_fwd_kernel<scalar_t, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<scalar_t, D><<<grid, NT, smem, stream>>>(
      (const scalar_t*)q, (const scalar_t*)k, (const scalar_t*)v, mask, (scalar_t*)o, lse, T, H,
      d, scale);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int D>
int dq_impl(const void* q, const void* k, const void* v, const float* mask, const void* dout,
            const float* lse, const float* delta, void* dq, int B, int T, int H, int d,
            float scale, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(flash_bwd_dq_kernel<scalar_t, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<scalar_t, D><<<grid, NT, smem, stream>>>(
      (const scalar_t*)q, (const scalar_t*)k, (const scalar_t*)v, mask, (const scalar_t*)dout, lse,
      delta, (scalar_t*)dq, T, H, d, scale);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int D>
int dkv_impl(const void* q, const void* k, const void* v, const float* mask, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv, int B, int T, int H, int d,
             float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<scalar_t, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<scalar_t, D><<<grid, NT, smem, stream>>>(
      (const scalar_t*)q, (const scalar_t*)k, (const scalar_t*)v, mask, (const scalar_t*)dout, lse,
      delta, (scalar_t*)dk, (scalar_t*)dv, T, H, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface: pointers and the stream come from the Python wrapper,
// which has already checked devices, dtypes, shapes and contiguity. Each
// returns the cudaError_t of its launch (0 = launched).
extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const float* mask, void* o,
              float* lse, int B, int T, int H, int d, float scale, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d > 64) return (int)cudaErrorInvalidValue;
  return bf16 ? fwd_impl<__nv_bfloat16, 64>(q, k, v, mask, o, lse, B, T, H, d, scale, s)
              : fwd_impl<float, 64>(q, k, v, mask, o, lse, B, T, H, d, scale, s);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const float* mask, const void* dout,
                 const float* lse, const float* delta, void* dq, int B, int T, int H, int d,
                 float scale, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d > 64) return (int)cudaErrorInvalidValue;
  return bf16 ? dq_impl<__nv_bfloat16, 64>(q, k, v, mask, dout, lse, delta, dq, B, T, H, d,
                                           scale, s)
              : dq_impl<float, 64>(q, k, v, mask, dout, lse, delta, dq, B, T, H, d, scale, s);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const float* mask,
                  const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                  int B, int T, int H, int d, float scale, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d > 64) return (int)cudaErrorInvalidValue;
  return bf16 ? dkv_impl<__nv_bfloat16, 64>(q, k, v, mask, dout, lse, delta, dk, dv, B, T, H, d,
                                            scale, s)
              : dkv_impl<float, 64>(q, k, v, mask, dout, lse, delta, dk, dv, B, T, H, d, scale,
                                    s);
}

}  // extern "C"
