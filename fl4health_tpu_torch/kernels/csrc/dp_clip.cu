// DP-SGD clip-and-reduce for Hopper (sm_90a): per-example squared norms over a
// whole gradient tree, and the scaled masked sum over examples.
//
// Replaces the two Pallas kernels of fl4health_tpu/kernels/dp_clip.py:
//   sq_norms_tree_kernel <- _sq_norm_kernel (K1), summed over the leaves as
//                           fused_clipped_masked_sum's sum(...) sums it
//   scaled_sum_kernel    <- _scaled_sum_kernel (K2)
//
// Both read gradient leaves in place as [N, B, W] stacks of N clients'
// [B, W] matrices (client stride cs and row stride ld elements, unit column
// stride; N = 1 outside the client vmap), f32 or bf16, and accumulate in f32.
// The TPU kernels pad W to 128-lane tiles; here the ragged edge is
// bounds-checked and nothing is copied. Under the simulation's vmap over
// clients (the JAX simulation's vmap(client_fit), under which Pallas batches
// its kernels), K1 takes the N * B rows of all clients as one launch, row r
// being row r % B of client r / B, and K2 takes the client as a second grid
// dimension; neither needs the clients' rows to be adjacent in memory, so no
// layout the vmap leaves behind costs a copy.
//
// What bounds them on this card: memory. Each reads its B x W elements once and
// does one or two flops per element read, far below the ~20 flops per byte the
// card sustains at 3.35 TB/s, so the bound is B * sum(W) * elem bytes over that
// rate. Loads are 16 bytes a thread (4 f32 or 8 bf16) where a leaf's base and
// row stride allow it, scalar otherwise.
//
// K1 is one launch over a table of up to MAX_LEAVES leaves, passed by value as
// a kernel parameter (a larger tree is one launch per group of that many, each
// adding onto the previous group's result). What the design does about
// - launches: a per-leaf two-stage reduction costs two launches, a workspace
//   and an add per leaf; the whole tree is one launch that also finishes the
//   sum;
// - narrow leaves: the work is a fixed, flattened list of items (leaf, row
//   group, column range), planned on the host from the shapes alone
//   (kernels/dp_clip.py, tree_plan), one CTA an item. A row wider than an
//   item is cut into column chunks; narrower rows are packed several to an
//   item (a power of two, NT / rows threads a row), so that a bias of 32 f32
//   columns keeps all 256 threads of a CTA loading instead of 8;
// - bytes in flight: every thread issues LOADS independent 16-byte loads
//   (streaming: no L1 allocation) before it uses them, into LOADS
//   accumulators that meet in a fixed tree, and an item is large enough (up
//   to 32 loads a thread) that a CTA's start and finish are a small part of
//   its time. The DP path's tree is one wave of CTAs.
// Each item writes one f32 partial per row into a workspace slot fixed by the
// item (the leaf's first slot + row * n_chunks + chunk), never by the CTA that
// ran it. Then each CTA takes one ticket from an unsigned counter behind a
// fence (an integer atomicInc, which wraps the counter back to 0 on the last
// ticket; there are no float atomics). The CTA with the last ticket sums, for
// each row, each leaf's partials in column order and then the leaves in leaf
// order (the JAX fold's order), and writes out[B]. So a launch is
// bit-identical to any other on the same inputs, whatever ran before it.
// Streams: launches that share a counter must run one after another. The
// wrapper keeps one counter (and workspace) per CUDA stream, and a stream runs
// its launches in order.
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

constexpr int NT = 256;         // threads per CTA
constexpr int MAX_LEAVES = 32;  // K1: leaves in one launch's table
constexpr int LOADS = 4;        // K1: independent loads a thread issues before it uses them
constexpr int MAX_SPLIT = 32;   // K2: most threads that share one column group

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

// A 16-byte load of data read once: no L1 allocation, and L2 fetches the
// whole 256-byte sector group.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// acc plus the squares of one 16-byte load's elements, in memory order.
template <typename T>
__device__ __forceinline__ float sq_acc(const uint4& u, float acc) {
  float v[Pack<T>::N];
  unpack(u, v);
#pragma unroll
  for (int k = 0; k < Pack<T>::N; ++k) acc = fmaf(v[k], v[k], acc);
  return acc;
}

// Thread q's part of sum(p[c]^2, c < n), for the tpr threads that share the
// row segment p[0, n): 16-byte packs q, q + tpr, ... (VEC), then elements
// (the ragged tail, or all of them on the scalar route), LOADS at a time.
template <typename T, bool VEC>
__device__ __forceinline__ float row_part(const T* __restrict__ p, int64_t n, int q, int tpr) {
  static_assert((LOADS & (LOADS - 1)) == 0, "the accumulators meet in a pairwise tree");
  float a[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) a[j] = 0.f;
  int64_t c = q;
  if (VEC) {
    constexpr int P = Pack<T>::N;
    const uint4* v = reinterpret_cast<const uint4*>(p);
    const int64_t n_packs = n / P;
    int64_t k = q;
    for (; k + (LOADS - 1) * tpr < n_packs; k += LOADS * tpr) {
      uint4 u[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) u[j] = ld_stream(v + k + j * tpr);
#pragma unroll
      for (int j = 0; j < LOADS; ++j) a[j] = sq_acc<T>(u[j], a[j]);
    }
    for (; k < n_packs; k += tpr) a[0] = sq_acc<T>(ld_stream(v + k), a[0]);
    c = n_packs * P + q;
  }
  for (; c + (LOADS - 1) * tpr < n; c += LOADS * tpr) {
    float x[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) x[j] = to_f32(__ldg(p + c + j * tpr));
#pragma unroll
    for (int j = 0; j < LOADS; ++j) a[j] = fmaf(x[j], x[j], a[j]);
  }
  for (; c < n; c += tpr) {
    const float x = to_f32(__ldg(p + c));
    a[0] = fmaf(x, x, a[0]);
  }
#pragma unroll
  for (int half = LOADS / 2; half > 0; half /= 2)
#pragma unroll
    for (int j = 0; j < half; ++j) a[j] += a[j + half];
  return a[0];
}

// Sum over each segment of tpr consecutive threads (a power of two up to NT)
// in a fixed tree, valid in the segment's first thread. tpr is the same for
// the whole CTA, so every thread reaches the barriers.
__device__ __forceinline__ float segment_sum(float x, int tpr) {
  __shared__ float warp_sums[NT / 32];
  const int seg = tpr < 32 ? tpr : 32;
  for (int off = seg / 2; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if (tpr > 32) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = x;
    __syncthreads();
    if (threadIdx.x % tpr == 0) {
      x = 0.f;
      for (int w = 0; w < tpr / 32; ++w) x += warp_sums[warp + w];
    }
  }
  return x;
}

// sum(p[i], i < n) in order, read from L2 (other CTAs wrote the values), 16
// independent loads at a time.
__device__ __forceinline__ float ordered_sum(const float* p, int n) {
  float s = 0.f;
  for (int i = 0; i < n; i += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = i + k < n ? __ldcg(p + i + k) : 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i + k < n) s += v[k];
  }
  return s;
}

enum : int { LEAF_BF16 = 1, LEAF_VEC = 2 };

// One leaf of K1's table, as the host plans it.
struct TreeLeaf {
  const void* base;  // [N, B / N, width]: client stride cs, row stride ld, unit column stride
  int64_t ld;
  int64_t cs;
  int64_t width;
  int64_t chunk;     // columns of a row that one item reads (a multiple of the pack)
  int64_t ws0;       // the leaf's first slot: row r, chunk c at ws0 + r * n_chunks + c
  int item0;         // the leaf's first item; its items run row group major
  int n_chunks;      // column chunks a row
  int rows;          // rows an item: a power of two, at most NT
  int flags;         // LEAF_BF16 | LEAF_VEC (base and row stride 16-byte aligned)
};

struct TreeTable {
  TreeLeaf leaf[MAX_LEAVES];
  int n_leaves, n_items, B;
  int client_rows;  // rows a client: row r is row r % client_rows of client r / client_rows
  int accumulate;  // 1: add onto out (an earlier group's result); 0: overwrite it
};

// Item `item` of the table: its leaf, rows [row0, row0 + rows), and columns
// [c0, c0 + n) of them.
struct Item {
  const TreeLeaf* lf;
  int row0, chunk;
  int64_t c0, n;
};

__device__ __forceinline__ Item decode(const TreeTable& table, int item) {
  int l = 0;
  while (l + 1 < table.n_leaves && item >= table.leaf[l + 1].item0) ++l;
  const TreeLeaf& lf = table.leaf[l];
  const int local = item - lf.item0;
  const int group = local / lf.n_chunks, chunk = local - group * lf.n_chunks;
  const int64_t c0 = chunk * lf.chunk;
  return {&lf, group * lf.rows, chunk, c0,
          (c0 + lf.chunk < lf.width ? c0 + lf.chunk : lf.width) - c0};
}

// K1: out[b] (+)= sum over the table's leaves, in order, of sum_c g_l[b, c]^2.
__global__ void __launch_bounds__(NT)
    sq_norms_tree_kernel(const __grid_constant__ TreeTable table, float* __restrict__ ws,
                         unsigned* __restrict__ counter, float* __restrict__ out) {
  const Item it = decode(table, blockIdx.x);
  const TreeLeaf& lf = *it.lf;
  const int tpr = NT / lf.rows, q = threadIdx.x % tpr;
  const int row = it.row0 + threadIdx.x / tpr;
  float x = 0.f;
  if (row < table.B) {
    const int64_t off = (int64_t)(row / table.client_rows) * lf.cs +
                        (int64_t)(row % table.client_rows) * lf.ld + it.c0;
    switch (lf.flags) {
      case LEAF_VEC:
        x = row_part<float, true>(static_cast<const float*>(lf.base) + off, it.n, q, tpr);
        break;
      case 0:
        x = row_part<float, false>(static_cast<const float*>(lf.base) + off, it.n, q, tpr);
        break;
      case LEAF_BF16 | LEAF_VEC:
        x = row_part<uint16_t, true>(static_cast<const uint16_t*>(lf.base) + off, it.n, q, tpr);
        break;
      default:
        x = row_part<uint16_t, false>(static_cast<const uint16_t*>(lf.base) + off, it.n, q, tpr);
    }
  }
  x = segment_sum(x, tpr);
  if (q == 0 && row < table.B) ws[lf.ws0 + (int64_t)row * lf.n_chunks + it.chunk] = x;

  // the CTA's partials are visible to every CTA before its ticket: a barrier,
  // then thread 0's fence (cumulative over what the barrier ordered before it)
  __shared__ unsigned ticket;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ticket = atomicInc(counter, gridDim.x - 1);
    __threadfence();
  }
  __syncthreads();
  if (ticket != gridDim.x - 1) return;

  // the last CTA: in each pass, thread t sums leaf t % L of row r0 + t / L in
  // column order; then thread j < NT / L adds its row's L leaf sums in leaf order
  __shared__ float leaf_sums[NT];
  const int L = table.n_leaves, rows_a_pass = NT / L, t = threadIdx.x;
  for (int r0 = 0; r0 < table.B; r0 += rows_a_pass) {
    const int row = r0 + t / L;
    if (t < rows_a_pass * L && row < table.B) {
      const TreeLeaf& lf = table.leaf[t % L];
      leaf_sums[t] = ordered_sum(ws + lf.ws0 + (int64_t)row * lf.n_chunks, lf.n_chunks);
    }
    __syncthreads();
    if (t < rows_a_pass && r0 + t < table.B) {
      float s = table.accumulate ? out[r0 + t] : 0.f;
      for (int k = 0; k < L; ++k) s += leaf_sums[t * L + k];
      out[r0 + t] = s;
    }
    __syncthreads();
  }
}

// K2: out[n, c] = sum over rows i, in order, of scale[n, i] * g[n, i, c], client
// n = blockIdx.y. Thread t owns columns [t*P, t*P + P).
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    scaled_sum_kernel(const T* __restrict__ g, int64_t ld, int64_t cs, int64_t W, int B,
                      const float* __restrict__ scale, float* __restrict__ out) {
  constexpr int P = Pack<T>::N;
  g += blockIdx.y * cs;
  scale += (int64_t)blockIdx.y * B;
  out += blockIdx.y * W;
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
    split_scaled_sum_kernel(const T* __restrict__ g, int64_t ld, int64_t cs, int64_t W, int B,
                            const float* __restrict__ scale, float* __restrict__ out,
                            int split) {
  constexpr int P = Pack<T>::N;
  g += blockIdx.y * cs;
  scale += (int64_t)blockIdx.y * B;
  out += blockIdx.y * W;
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

// 16-byte loads need a 16-byte aligned base and row and client strides that
// keep every row aligned.
template <typename T>
bool vector_ok(const void* g, int64_t ld, int64_t cs) {
  return reinterpret_cast<uintptr_t>(g) % 16 == 0 && (ld * (int64_t)sizeof(T)) % 16 == 0 &&
         (cs * (int64_t)sizeof(T)) % 16 == 0;
}

// A table row as the host sends it, checked against what the kernel assumes.
bool leaf_ok(const TreeLeaf& lf) {
  const int64_t elem = lf.flags & LEAF_BF16 ? 2 : 4;
  const uintptr_t base = reinterpret_cast<uintptr_t>(lf.base);
  // every chunk of a row starts 16-byte aligned
  const bool vec_ok = base % 16 == 0 && lf.ld * elem % 16 == 0 && lf.cs * elem % 16 == 0 &&
                      (lf.n_chunks == 1 || lf.chunk * elem % 16 == 0);
  return lf.width > 0 && lf.ld >= lf.width && lf.cs >= 0 && lf.chunk > 0 && lf.n_chunks >= 1 &&
         (int64_t)(lf.n_chunks - 1) * lf.chunk < lf.width &&
         (int64_t)lf.n_chunks * lf.chunk >= lf.width && lf.rows >= 1 && lf.rows <= NT &&
         (lf.rows & (lf.rows - 1)) == 0 && lf.flags >= 0 && lf.flags <= 3 &&
         (!(lf.flags & LEAF_VEC) || vec_ok);
}

template <typename T>
int scaled_sum_impl(const void* g_, int64_t ld, int64_t cs, int64_t W, int B, int N,
                    const float* scale, float* out, int split, cudaStream_t s) {
  const T* g = static_cast<const T*>(g_);
  constexpr int P = Pack<T>::N;
  const int64_t groups = (W + P - 1) / P;
  const bool vec = vector_ok<T>(g_, ld, cs);
  if (split > 1) {
    const dim3 grid((unsigned)((groups + NT / split - 1) / (NT / split)), (unsigned)N);
    if (vec)
      split_scaled_sum_kernel<T, true><<<grid, NT, 0, s>>>(g, ld, cs, W, B, scale, out, split);
    else
      split_scaled_sum_kernel<T, false><<<grid, NT, 0, s>>>(g, ld, cs, W, B, scale, out, split);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((groups + NT - 1) / NT), (unsigned)N);
  if (vec)
    scaled_sum_kernel<T, true><<<grid, NT, 0, s>>>(g, ld, cs, W, B, scale, out);
  else
    scaled_sum_kernel<T, false><<<grid, NT, 0, s>>>(g, ld, cs, W, B, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// leaves: n_leaves rows of 10 integers, each a TreeLeaf in its field order (base
// address, ld, cs, width, chunk, ws0, item0, n_chunks, rows, flags), the items
// of leaf l running from item0 for ceil(B / rows) * n_chunks; B: the rows of
// all clients, client_rows of each; ws: the plan's slots, f32; counter: one
// unsigned, 0 between launches; out: [B] f32. One CTA an item.
int dp_sq_norms_tree(const int64_t* leaves, int n_leaves, int n_items, int B, int client_rows,
                     float* ws, unsigned* counter, float* out, int accumulate, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_items < 1 || B <= 0 || B > 65535 ||
      client_rows < 1 || B % client_rows != 0)
    return (int)cudaErrorInvalidValue;
  TreeTable t{};
  t.n_leaves = n_leaves;
  t.n_items = n_items;
  t.B = B;
  t.client_rows = client_rows;
  t.accumulate = accumulate ? 1 : 0;
  int64_t next_item = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* f = leaves + 10 * l;
    TreeLeaf& lf = t.leaf[l];
    lf.base = reinterpret_cast<const void*>(f[0]);
    lf.ld = f[1];
    lf.cs = f[2];
    lf.width = f[3];
    lf.chunk = f[4];
    lf.ws0 = f[5];
    lf.item0 = (int)f[6];
    lf.n_chunks = (int)f[7];
    lf.rows = (int)f[8];
    lf.flags = (int)f[9];
    if (!leaf_ok(lf) || f[6] != next_item) return (int)cudaErrorInvalidValue;
    next_item += (int64_t)((B + lf.rows - 1) / lf.rows) * lf.n_chunks;
  }
  if (next_item != n_items) return (int)cudaErrorInvalidValue;
  sq_norms_tree_kernel<<<n_items, NT, 0, (cudaStream_t)stream>>>(t, ws, counter, out);
  return (int)cudaGetLastError();
}

// g: [N, B, W] with client stride cs and row stride ld; scale: [N, B] f32,
// contiguous; out: [N, W] f32, contiguous; split: threads that share a column
// group, a power of two from 1 to MAX_SPLIT. One launch for all N clients.
int dp_scaled_sum(const void* g, int64_t ld, int64_t cs, int64_t W, int B, int N,
                  const float* scale, float* out, int split, int bf16, void* stream) {
  if (B <= 0 || W <= 0 || N < 1 || N > 65535 || ld < W || cs < 0 || split < 1 ||
      split > MAX_SPLIT || (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? scaled_sum_impl<uint16_t>(g, ld, cs, W, B, N, scale, out, split, s)
              : scaled_sum_impl<float>(g, ld, cs, W, B, N, scale, out, split, s);
}

const char* dp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
