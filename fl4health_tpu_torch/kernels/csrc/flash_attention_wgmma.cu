// Flash attention for Hopper (sm_90a) on the tensor cores: the bf16 forward,
// dQ and dK/dV kernels.
//
// Replace the three Pallas kernels of fl4health_tpu/kernels/flash_attention.py
// for bf16 inputs whose head dim d is at most 64 with d * 2 bytes a multiple of
// 16 (the rule is the wrapper's, kernels/flash_attention.py `wgmma_route`):
//   wgmma_flash_fwd_kernel     <- _fwd_kernel     (online-softmax forward, O and lse)
//   wgmma_flash_bwd_dq_kernel  <- _bwd_dq_kernel  (dQ over key tiles)
//   wgmma_flash_bwd_dkv_kernel <- _bwd_dkv_kernel (dK and dV over query tiles)
// f32 inputs and other head dims run flash_attention.cu.
//
// Precision is the reference's own: the JAX kernel takes Precision.DEFAULT for
// bf16 operands, which on its chip feeds bf16 to the matrix unit with f32
// accumulation. Every product here is `wgmma.mma_async m64n64k16
// .f32.bf16.bf16`: Q K^T and dO V^T of bf16 operands are exact products summed
// in f32; P (forward; l sums the f32 P before it is rounded), dS (dQ), P^T and
// dS^T (dK/dV) are rounded to bf16 once, as the register A operand of the next
// product. The wrapper's `bf16_operand_bounds` states what that rounding may
// cost.
//
// What bounds them on this card: at T = 2048 all three are compute-bound (4*D,
// 6*D and 8*D operations per query-key pair against 2*D bytes a row), so the
// ceiling is the bf16 tensor-core rate. The design, for that ceiling:
//   * one CTA = two consumer warpgroups of 64 rows each (128 query rows of one
//     (b, h) for the forward and dQ, 128 keys for dK/dV) and one producer warp
//     whose first thread issues TMA loads; at 288 threads and one CTA an SM
//     every thread may hold 224 registers, which covers dK/dV's four 64 x 64
//     f32 fragments without `setmaxnreg`;
//   * tiles are 64 x 64 bf16 (one 128-byte row per token) loaded by TMA from a
//     4-D tensor map {D, H, T, B} with box {64, 1, 64, 1} and the 128-byte
//     swizzle, so rows past T and columns past d arrive as zeros with no
//     padding copy, and wgmma reads them through matching descriptors;
//   * a ring of K/V (forward, dQ) or Q/dO (dK/dV) stages with one `mbarrier`
//     pair (full, empty) per stage overlaps the loads with the math;
//   * the softmax runs on the f32 accumulator fragment; row reductions are two
//     shuffles among the four threads that share a row;
//   * the forward's and dQ's producers skip key tiles that are all padding
//     (their probabilities are exactly 0); a dK/dV warpgroup whose 64 keys are
//     all padding writes zeros without looping;
//   * no state crosses CTAs and there are no atomics: each output row is
//     written once, so the kernels are bit-reproducible run to run.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

constexpr int TILE = 64;                     // rows (and bf16 columns) of every tile
constexpr int TILE_BYTES = TILE * TILE * 2;  // 8 KB, 1024-byte aligned in shared memory
constexpr int NTHREADS = 288;                // consumer warpgroups 0, 1; producer warp 8
constexpr int FWD_STAGES = 3;
constexpr int DKV_STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed. A wait
// that lasts 2^35 cycles (about 20 s; a real one takes microseconds) can only
// be a fault in the protocol: it traps, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  } while (!done);
}

// One 64 x 64 box at coordinates {c0 (d), c1 (h), c2 (t), c3 (b)}.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a 64-row tile with 128-byte rows in the
// 128-byte swizzle (as TMA wrote it; the tile is 1024-byte aligned).
//   K-major (the reduction dim contiguous in a row): 8-row groups 1024 bytes
//     apart (SBO); LBO is unused. A k16 step moves the start by 32 bytes.
//   MN-major (the output dim contiguous): the same 1024-byte stride between
//     8-row groups along the reduction dim; N = 64 is one swizzle atom wide,
//     so the two offsets are both 1024. A k16 step moves the start by 2048.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return desc_sw128(addr, 16); }
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from reading an accumulator (or reusing an A register)
// across an asynchronous wgmma: called after wgmma_wait_all.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC32(d)                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, shared memory, K-major) * B (16 x 64, shared memory)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers) * B (16 x 64, shared memory)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragment of a 64 x 64 f32 wgmma tile: thread (warp w, lane
// l) holds rows 16w + l/4 (regs 4i, 4i+1) and 16w + l/4 + 8 (regs 4i+2, 4i+3)
// at columns 8i + 2(l%4) + {0, 1}. Columns 16j..16j+15 of that fragment,
// rounded to bf16, are exactly the A register fragment of the k16 step j.
__device__ __forceinline__ void to_a_operand(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[4 * j + 0] = pack_bf16(x[8 * j + 0], x[8 * j + 1]);
    a[4 * j + 1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[4 * j + 2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[4 * j + 3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, where the plain version's exp gives a denormal).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of the 16-byte chunk `j` of row `r` in a 64 x 64 bf16 staging
// tile with the 128-byte swizzle (spreads a warp's rows over the banks).
__device__ __forceinline__ int stage_offset(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// Write a 64 x 64 f32 accumulator (times `mul` per row) as bf16 into the
// staging tile `st` of this warpgroup, then copy the rows below `t_end` out
// with 16-byte stores: dst row t at dst + t * rs, columns below d.
__device__ __forceinline__ void store_tile(const float (&acc)[32], const float (&mul)[2],
                                           uint8_t* st, __nv_bfloat16* dst, int t0, int t_end,
                                           int rs, int d, int r_lo, int cq, int tw,
                                           int barrier) {
  named_sync(barrier);  // every warp of the group is done reading `st` as an operand
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      *reinterpret_cast<uint32_t*>(st + stage_offset(r, i) + cq * 2) =
          pack_bf16(acc[4 * i + 2 * half] * mul[half], acc[4 * i + 2 * half + 1] * mul[half]);
    }
  named_sync(barrier);
  for (int idx = tw; idx < TILE * 8; idx += 128) {
    const int r = idx >> 3, j = idx & 7, t = t0 + r;
    if (t < t_end && j * 8 < d)
      *reinterpret_cast<uint4*>(dst + (size_t)t * rs + j * 8) =
          *reinterpret_cast<const uint4*>(st + stage_offset(r, j));
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The prologue of a query-stationary kernel (forward, dQ), run by every
// thread of the CTA: the key bitmask of its batch element (bit c of word w:
// key 32w + c is real), built with ballots while thread 0 initialises the
// barriers (the resident tiles' one and the key ring's full/empty pairs),
// then the list of the `key_tiles` key tiles that hold a real key, in order.
// Returns the list's length, the same in every thread.
__device__ __forceinline__ int key_tile_list(const float* mrow, int T, int key_tiles, int tid,
                                             int warp, int lane, uint32_t* key_bits, int* tiles,
                                             int& n_tiles, uint64_t* resident, uint64_t* full,
                                             uint64_t* empty) {
  for (int w = warp; w < 2 * key_tiles; w += NTHREADS / 32) {
    const int t = 32 * w + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, t < T && mrow[t] > 0.f);
    if (lane == 0) key_bits[w] = bits;
  }
  if (tid == 0) {
    mbar_init(resident, 1);
    for (int i = 0; i < FWD_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j < key_tiles; ++j)
      if (key_bits[2 * j] | key_bits[2 * j + 1]) tiles[n++] = j;
    n_tiles = n;
  }
  __syncthreads();
  return n_tiles;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// One key tile of the online softmax on the S fragment (raw Q K^T): sc
// becomes P = 2^(S scale log2e - m) in f32, m (log2 units) and l advance,
// and corr is the factor that rescales the rows of O. MASKED: bit 8i + e of
// `bits` says whether this thread's column 8i + cq + e is a real key.
template <bool MASKED>
__device__ __forceinline__ void online_softmax(float (&sc)[32], uint64_t bits, float sl2,
                                               float (&m)[2], float (&l)[2], float (&corr)[2]) {
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& x = sc[4 * i + 2 * half + e];
        if (MASKED && !((bits >> (8 * i + e)) & 1)) x = NEG_INF;
        mt[half] = fmaxf(mt[half], x);
      }
  float m_new[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // scale > 0, so the max of the scaled logits is the scaled max; a tile
    // reaches here only with a real key, so every row's max is finite
    m_new[half] = fmaxf(m[half], quad_max(mt[half]) * sl2);
    corr[half] = ex2(m[half] - m_new[half]);
    m[half] = m_new[half];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& x = sc[4 * i + 2 * half + e];
        x = ex2(fmaf(x, sl2, -m_new[half]));
        if (MASKED && !((bits >> (8 * i + e)) & 1)) x = 0.f;
        rsum[half] += x;
      }
#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + quad_sum(rsum[half]);
}

struct FwdSmem {
  __nv_bfloat16 q[2][TILE * TILE];  // one 64-row slice per consumer warpgroup
  __nv_bfloat16 k[FWD_STAGES][TILE * TILE];
  __nv_bfloat16 v[FWD_STAGES][TILE * TILE];
  uint64_t q_full, full[FWD_STAGES], empty[FWD_STAGES];
  int n_tiles;
  // then key_bits[2 * key tiles] (bit c of word w: key 32w + c is real) and
  // tiles[key tiles] (the key tiles with a real key, in order)
};

__global__ void __launch_bounds__(NTHREADS, 1)
wgmma_flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const MaskRows mask,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T, int H,
                       int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(base);
  const int key_tiles = (T + TILE - 1) / TILE;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(base + sizeof(FwdSmem));
  int* tiles = reinterpret_cast<int*>(key_bits + 2 * key_tiles);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 2 * TILE;
  const float* mrow = mask_row(mask, b, T);

  const int n_tiles = key_tile_list(mrow, T, key_tiles, tid, warp, lane, key_bits, tiles,
                                    s.n_tiles, &s.q_full, s.full, s.empty);

  if (warp == 8) {  // producer warp
    if (lane == 0) {
      const bool second = q0 + TILE < T;  // a box wholly past T is not loaded
      mbar_expect_tx(&s.q_full, TILE_BYTES * (second ? 2 : 1));
      tma_load(s.q[0], &tm_q, &s.q_full, 0, h, q0, b);
      if (second) tma_load(s.q[1], &tm_q, &s.q_full, 0, h, q0 + TILE, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % FWD_STAGES;
        if (n >= FWD_STAGES) mbar_wait(&s.empty[st], (n / FWD_STAGES - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
        tma_load(s.k[st], &tm_k, &s.full[st], 0, h, tiles[n] * TILE, b);
        tma_load(s.v[st], &tm_v, &s.full[st], 0, h, tiles[n] * TILE, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    const int wg = warp / 4, tw = tid % 128;
    const int r_lo = 16 * (warp % 4) + lane / 4, cq = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    // m: running row max of the logits in log2 units; l: running row sum
    float acc[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(s.q[wg]);
    mbar_wait(&s.q_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % FWD_STAGES;
      mbar_wait(&s.full[st], (n / FWD_STAGES) & 1);
      const uint32_t k_addr = smem_u32(s.k[st]), v_addr = smem_u32(s.v[st]);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(sc, desc_kmajor(q_addr + 32 * kk), desc_kmajor(k_addr + 32 * kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // key mask and online softmax on the fragment; sc becomes P (f32).
      // Only a key tile with padding pays for the mask.
      const uint32_t lo = key_bits[2 * tiles[n]], hi = key_bits[2 * tiles[n] + 1];
      float corr[2];
      if ((lo & hi) == 0xffffffffu)
        online_softmax<false>(sc, 0, sl2, m, l, corr);
      else
        online_softmax<true>(sc, (((uint64_t)hi << 32) | lo) >> cq, sl2, m, l, corr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[4 * i + 0] *= corr[0];
        acc[4 * i + 1] *= corr[0];
        acc[4 * i + 2] *= corr[1];
        acc[4 * i + 3] *= corr[1];
      }

      // O += P V: P (bf16) from registers, V [key][d] as the MN-major B operand
      uint32_t pa[16];
      to_a_operand(sc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                    desc_mnmajor(v_addr + 2048 * kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&s.empty[st]);
    }

    // a row with no real key keeps l = 0: O = 0 and lse = -1e30 + log(1e-20)
    const float denom[2] = {fmaxf(l[0], 1e-20f), fmaxf(l[1], 1e-20f)};
    const float inv[2] = {1.f / denom[0], 1.f / denom[1]};
    const int t0 = q0 + TILE * wg, rs = H * d;
    if (lane % 4 == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + r_lo + 8 * half;
        // back to natural units; a row that saw no key keeps m = NEG_INF
        const float m_nat = m[half] == NEG_INF ? NEG_INF : m[half] * (1.f / LOG2E);
        if (t < T) lse[(size_t)bh * T + t] = m_nat + logf(denom[half]);
      }
    }
    store_tile(acc, inv, reinterpret_cast<uint8_t*>(s.q[wg]),
               o + (size_t)b * T * rs + (size_t)h * d, t0, T, rs, d, r_lo, cq, tw, 1 + wg);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// One key tile of dQ on the S and dP fragments (raw Q K^T and dO V^T, rows
// are queries): ds becomes dS = P (dP - delta) scale, with P = 2^(S scale
// log2e - lse log2e) and P = 0 for padding keys. lse_l2 and del are this
// thread's two rows' lse (log2 units) and delta. MASKED: bit 8i + e of `bits`
// says whether this thread's column 8i + cq + e is a real key.
template <bool MASKED>
__device__ __forceinline__ void score_grad(const float (&sc)[32], float (&ds)[32], uint64_t bits,
                                           float sl2, const float (&lse_l2)[2],
                                           const float (&del)[2], float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 4 * i + 2 * half + e;
        float p = ex2(fmaf(sc[j], sl2, -lse_l2[half]));
        if (MASKED && !((bits >> (8 * i + e)) & 1)) p = 0.f;
        ds[j] = p * (ds[j] - del[half]) * scale;
      }
}

struct DqSmem {
  __nv_bfloat16 q[2][TILE * TILE];  // resident: one 64-row slice per consumer warpgroup
  __nv_bfloat16 dout[2][TILE * TILE];
  __nv_bfloat16 k[FWD_STAGES][TILE * TILE];  // streamed key tiles
  __nv_bfloat16 v[FWD_STAGES][TILE * TILE];
  uint64_t qdo_full, full[FWD_STAGES], empty[FWD_STAGES];
  int n_tiles;
  // then key_bits and tiles, as in the forward
};

__global__ void __launch_bounds__(NTHREADS, 1)
wgmma_flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const MaskRows mask, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int T,
                          int H, int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  DqSmem& s = *reinterpret_cast<DqSmem*>(base);
  const int key_tiles = (T + TILE - 1) / TILE;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(base + sizeof(DqSmem));
  int* tiles = reinterpret_cast<int*>(key_bits + 2 * key_tiles);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 2 * TILE;
  const float* mrow = mask_row(mask, b, T);

  // a batch element with no real key has no tile: nothing is loaded, dQ = 0
  const int n_tiles = key_tile_list(mrow, T, key_tiles, tid, warp, lane, key_bits, tiles,
                                    s.n_tiles, &s.qdo_full, s.full, s.empty);

  if (warp == 8) {  // producer warp
    if (lane == 0 && n_tiles > 0) {
      const bool second = q0 + TILE < T;  // a box wholly past T is not loaded
      mbar_expect_tx(&s.qdo_full, 2 * TILE_BYTES * (second ? 2 : 1));
      for (int i = 0; i < (second ? 2 : 1); ++i) {
        tma_load(s.q[i], &tm_q, &s.qdo_full, 0, h, q0 + TILE * i, b);
        tma_load(s.dout[i], &tm_do, &s.qdo_full, 0, h, q0 + TILE * i, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % FWD_STAGES;
        if (n >= FWD_STAGES) mbar_wait(&s.empty[st], (n / FWD_STAGES - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
        tma_load(s.k[st], &tm_k, &s.full[st], 0, h, tiles[n] * TILE, b);
        tma_load(s.v[st], &tm_v, &s.full[st], 0, h, tiles[n] * TILE, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    const int wg = warp / 4, tw = tid % 128;
    const int r_lo = 16 * (warp % 4) + lane / 4, cq = 2 * (lane % 4);
    const int t0 = q0 + TILE * wg, rs = H * d;
    const float sl2 = scale * LOG2E, ones[2] = {1.f, 1.f};
    // lse (log2 units) and delta of this thread's two fragment rows; a row
    // past T reads neither (its Q and dO rows are zeros and it is not stored)
    float lse_l2[2], del[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + r_lo + 8 * half;
      lse_l2[half] = t < T ? lse[(size_t)bh * T + t] * LOG2E : 0.f;
      del[half] = t < T ? delta[(size_t)bh * T + t] : 0.f;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    if (n_tiles > 0) {
      const uint32_t q_addr = smem_u32(s.q[wg]), do_addr = smem_u32(s.dout[wg]);
      mbar_wait(&s.qdo_full, 0);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % FWD_STAGES;
        mbar_wait(&s.full[st], (n / FWD_STAGES) & 1);
        const uint32_t k_addr = smem_u32(s.k[st]), v_addr = smem_u32(s.v[st]);
        // S = Q K^T and dP = dO V^T, both issued before one wait
        float sc[32], ds[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = ds[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(sc, desc_kmajor(q_addr + 32 * kk), desc_kmajor(k_addr + 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(ds, desc_kmajor(do_addr + 32 * kk), desc_kmajor(v_addr + 32 * kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(ds);

        // dS on the fragment; only a key tile with padding pays for the mask
        const uint32_t lo = key_bits[2 * tiles[n]], hi = key_bits[2 * tiles[n] + 1];
        if ((lo & hi) == 0xffffffffu)
          score_grad<false>(sc, ds, 0, sl2, lse_l2, del, scale);
        else
          score_grad<true>(sc, ds, (((uint64_t)hi << 32) | lo) >> cq, sl2, lse_l2, del, scale);

        // dQ += dS K: dS (bf16) from registers, K [key][d] as the MN-major B
        // operand (as V is in the forward's P V)
        uint32_t da[16];
        to_a_operand(ds, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                      desc_mnmajor(k_addr + 2048 * kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(da);
        mbar_arrive(&s.empty[st]);
      }
    }
    // the Q slot is the staging tile: every product that read it is done
    store_tile(acc, ones, reinterpret_cast<uint8_t*>(s.q[wg]),
               dq + (size_t)b * T * rs + (size_t)h * d, t0, T, rs, d, r_lo, cq, tw, 1 + wg);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

struct DkvSmem {
  __nv_bfloat16 k[2][TILE * TILE];  // resident: one 64-key slice per consumer warpgroup
  __nv_bfloat16 v[2][TILE * TILE];
  __nv_bfloat16 q[DKV_STAGES][TILE * TILE];  // streamed query tiles
  __nv_bfloat16 dout[DKV_STAGES][TILE * TILE];
  float lse[DKV_STAGES][TILE];
  float delta[DKV_STAGES][TILE];
  uint64_t kv_full, full[DKV_STAGES], empty[DKV_STAGES];
};

__global__ void __launch_bounds__(NTHREADS, 1)
wgmma_flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const MaskRows mask, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T, int H, int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * 2 * TILE;
  const float* mrow = mask_row(mask, b, T);
  const int n_q = (T + TILE - 1) / TILE;

  // which of the two 64-key slices hold a real key
  const auto real = [&](int t) { return t < T && mrow[t] > 0.f; };
  const bool live0 = __syncthreads_or(tid < TILE && real(k0 + tid)) != 0;
  const bool live1 = __syncthreads_or(tid >= TILE && tid < 2 * TILE && real(k0 + tid)) != 0;
  if (tid == 0) {
    mbar_init(&s.kv_full, 1);
    for (int i = 0; i < DKV_STAGES; ++i) {
      mbar_init(&s.full[i], 1 + 32);  // the TMA thread's expect_tx + the warp's lse/delta
      mbar_init(&s.empty[i], max(1, 128 * ((int)live0 + (int)live1)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer warp; lane 0 issues TMA
    if (live0 || live1) {
      if (lane == 0) {  // only live slices: a dead one's slots stage its zeros
        mbar_expect_tx(&s.kv_full, 2 * TILE_BYTES * ((int)live0 + (int)live1));
        for (int i = 0; i < 2; ++i)
          if (i == 0 ? live0 : live1) {
            tma_load(s.k[i], &tm_k, &s.kv_full, 0, h, k0 + TILE * i, b);
            tma_load(s.v[i], &tm_v, &s.kv_full, 0, h, k0 + TILE * i, b);
          }
      }
      const float* lrow = lse + (size_t)bh * T;
      const float* drow = delta + (size_t)bh * T;
      for (int n = 0; n < n_q; ++n) {
        const int st = n % DKV_STAGES, q0 = n * TILE;
        if (n >= DKV_STAGES) mbar_wait(&s.empty[st], (n / DKV_STAGES - 1) & 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lane + 32 * e, t = q0 + r;
          s.lse[st][r] = t < T ? lrow[t] : 0.f;
          s.delta[st][r] = t < T ? drow[t] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
          tma_load(s.q[st], &tm_q, &s.full[st], 0, h, q0, b);
          tma_load(s.dout[st], &tm_do, &s.full[st], 0, h, q0, b);
        }
        mbar_arrive(&s.full[st]);
      }
    }
  } else {  // consumer warpgroup wg: keys k0 + 64 wg + [0, 64)
    const int wg = warp / 4, tw = tid % 128;
    const int r_lo = 16 * (warp % 4) + lane / 4, cq = 2 * (lane % 4);
    const int t0 = k0 + TILE * wg, rs = H * d;
    const size_t off = (size_t)b * T * rs + (size_t)h * d;
    const float ones[2] = {1.f, 1.f};
    float adk[32], adv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;

    if (wg == 0 ? live0 : live1) {
      // key validity of this thread's two fragment rows
      const bool key_ok[2] = {real(t0 + r_lo), real(t0 + r_lo + 8)};
      const float sl2 = scale * LOG2E;
      const uint32_t k_addr = smem_u32(s.k[wg]), v_addr = smem_u32(s.v[wg]);
      mbar_wait(&s.kv_full, 0);
      for (int n = 0; n < n_q; ++n) {
        const int st = n % DKV_STAGES, q0 = n * TILE;
        mbar_wait(&s.full[st], (n / DKV_STAGES) & 1);
        const uint32_t q_addr = smem_u32(s.q[st]), do_addr = smem_u32(s.dout[st]);
        // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(sc, desc_kmajor(k_addr + 32 * kk), desc_kmajor(q_addr + 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(dp, desc_kmajor(v_addr + 32 * kk), desc_kmajor(do_addr + 32 * kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // P^T = exp(S^T scale - lse); dS^T = P^T (dP^T - delta) scale. Padding
        // keys and query rows past T give exactly 0.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * i + cq + e;
            const bool q_ok = q0 + c < T;
            const float lse_l2 = s.lse[st][c] * LOG2E, del = s.delta[st][c];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = 4 * i + 2 * half + e;
              const float p = (key_ok[half] && q_ok) ? ex2(fmaf(sc[j], sl2, -lse_l2)) : 0.f;
              sc[j] = p;
              dp[j] = p * (dp[j] - del) * scale;
            }
          }

        // dV += P^T dO and dK += dS^T Q: A from registers (bf16), dO and Q
        // [query][d] as MN-major B operands
        uint32_t pa[16], da[16];
        to_a_operand(sc, pa);
        to_a_operand(dp, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(adv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      desc_mnmajor(do_addr + 2048 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(adk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                      desc_mnmajor(q_addr + 2048 * kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(adv);
        fence_regs(adk);
        fence_regs(pa);
        fence_regs(da);
        mbar_arrive(&s.empty[st]);
      }
    }
    // a slice of padding keys has P = 0 for every query: dK = dV = 0 (the
    // accumulators are still zero); its k/v slots were never loaded
    store_tile(adk, ones, reinterpret_cast<uint8_t*>(s.k[wg]), dk + off, t0, T, rs, d, r_lo,
               cq, tw, 1 + wg);
    store_tile(adv, ones, reinterpret_cast<uint8_t*>(s.v[wg]), dv + off, t0, T, rs, d, r_lo,
               cq, tw, 1 + wg);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr int ERR_NO_ENCODER = 100001;  // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 100002;      // cuTensorMapEncodeTiled refused the tensor

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver's tensor-map encoder, fetched through the runtime so that the
// extension needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, T, H, d] bf16 (row stride H*d) as a 4-D map {d, H, T, B}, box {64, 1, 64, 1}.
int encode(CUtensorMap* map, const void* ptr, int B, int T, int H, int d) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)H * d * 2,
                                 (cuuint64_t)T * H * d * 2};
  const cuuint32_t box[4] = {TILE, 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// Dynamic shared memory a launch requests: the 1024-byte alignment slack,
// the layout, and (forward, dQ) the key bitmask and tile list for T keys.
size_t key_list_bytes(int T) {
  const int key_tiles = (T + TILE - 1) / TILE;
  return sizeof(uint32_t) * 2 * key_tiles + sizeof(int) * key_tiles;
}
size_t fwd_smem_bytes(int T) { return 1024 + sizeof(FwdSmem) + key_list_bytes(T); }
size_t dq_smem_bytes(int T) { return 1024 + sizeof(DqSmem) + key_list_bytes(T); }
size_t dkv_smem_bytes() { return 1024 + sizeof(DkvSmem); }

}  // namespace

extern "C" {

// mask: the key mask as MaskRows (flash_mask.cuh), as in flash_attention.cu.
int flash_fwd_wgmma(const void* q, const void* k, const void* v, const float* mask,
                    int mask_rows, long long mask_stride, void* o, float* lse, int B, int T,
                    int H, int d, float scale, void* stream) {
  if (mask_rows < 1 || mask_stride < 0) return (int)cudaErrorInvalidValue;
  const MaskRows rows{mask, mask_rows, mask_stride};
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = encode(&tq, q, B, T, H, d)) || (err = encode(&tk, k, B, T, H, d)) ||
      (err = encode(&tv, v, B, T, H, d)))
    return err;
  const size_t smem = fwd_smem_bytes(T);
  cudaError_t e = cudaFuncSetAttribute(wgmma_flash_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + 2 * TILE - 1) / (2 * TILE), B * H);
  wgmma_flash_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, rows, (__nv_bfloat16*)o, lse, T, H, d, scale);
  return (int)cudaGetLastError();
}

int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const float* mask,
                       int mask_rows, long long mask_stride, const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int T, int H, int d, float scale,
                       void* stream) {
  if (mask_rows < 1 || mask_stride < 0) return (int)cudaErrorInvalidValue;
  const MaskRows rows{mask, mask_rows, mask_stride};
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = encode(&tq, q, B, T, H, d)) || (err = encode(&tk, k, B, T, H, d)) ||
      (err = encode(&tv, v, B, T, H, d)) || (err = encode(&tdo, dout, B, T, H, d)))
    return err;
  const size_t smem = dq_smem_bytes(T);
  cudaError_t e = cudaFuncSetAttribute(wgmma_flash_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + 2 * TILE - 1) / (2 * TILE), B * H);
  wgmma_flash_bwd_dq_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, rows, lse, delta, (__nv_bfloat16*)dq, T, H, d, scale);
  return (int)cudaGetLastError();
}

int flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const float* mask,
                        int mask_rows, long long mask_stride, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int T, int H, int d,
                        float scale, void* stream) {
  if (mask_rows < 1 || mask_stride < 0) return (int)cudaErrorInvalidValue;
  const MaskRows rows{mask, mask_rows, mask_stride};
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = encode(&tq, q, B, T, H, d)) || (err = encode(&tk, k, B, T, H, d)) ||
      (err = encode(&tv, v, B, T, H, d)) || (err = encode(&tdo, dout, B, T, H, d)))
    return err;
  const size_t smem = dkv_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(wgmma_flash_bwd_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + 2 * TILE - 1) / (2 * TILE), B * H);
  wgmma_flash_bwd_dkv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, rows, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, T, H, d, scale);
  return (int)cudaGetLastError();
}

const char* flash_wgmma_error_string(int code) {
  if (code == ERR_NO_ENCODER) return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the tensor";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
