// Linear attention, forward and backward, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tedm_tpu/ops/pallas/linear_attention.py:
// the forward _fwd_kernel (launched by _fwd_pallas) and the backward
// _bwd_kernel (launched by _bwd_pallas, tied in by jax.custom_vjp). For each
// (batch, head) pair, over q, k, v of shape (d = 32, N):
//
//     s   = softmax_d(q)               p = softmax_N(k)
//     C   = p (v / N)^T                (d x d context)
//     out = scale * C^T s              (d x N)
//
// and, for an output gradient g (d x N), with dC' = s g^T (unscaled):
//
//     dq = s * (ds - sum_d s*ds),      ds = scale * C g
//     dv = (scale / N) dC'^T p
//     dk = p * (dp - r),               dp = (scale / N) dC' v,
//                                      r[d] = sum_n p dp = sum_e dC'[d,e] (scale C)[d,e]
//
// What bounds it: memory. The forward reads q, k, v and writes out,
// 4*B*h*d*N*4 bytes, for 4*B*h*d*d*N FLOPs; the backward reads q, k, v, g and
// writes dq, dk, dv, 7*B*h*d*N*4 bytes, for about 8*B*h*d*d*N FLOPs in its four
// 32-deep contractions. Both are about 8 FLOPs per byte: at the training shape
// (16, 4, 32, 16384) the backward moves 940 MB, 0.28 ms at 3.35 TB/s.
//
// Design. The TPU kernels hold one (b, h) row of N in VMEM and walk the grid
// in order. On the H100 one block per (b, h) would fill 32 of 132 SMs and a
// row does not fit in shared memory, so N is split across blocks.
// Forward, three launches on the caller's stream, on the CUDA cores:
//   1. context_partials: grid (chunks of 512 columns, B*h). A block stages
//      128-column tiles of k and v in shared memory and keeps a running
//      row max m[d], sum-exp l[d] and unnormalised context
//      P[d][e] = sum_n exp(k[d,n] - m[d]) v[e,n], rescaled by exp(m_old - m)
//      when the max grows (the online softmax). Each thread owns a 4x4
//      block of P over a quarter of the tile's columns; the quarters are
//      summed once at the end.
//   2. combine_context: grid B*h. Merges the chunks' (m, l, P) into
//      scale*C[d][e] = scale * sum_c P_c exp(m_c - m) / (N * sum_c l_c exp(m_c - m))
//      and writes it with the row statistics (m, l) for the backward.
//   3. apply_context: grid (N / 256, B*h). One thread per column: softmax
//      of q over d in registers, then out[e] = sum_d (scale C)[d][e] s[d]
//      with the context in shared memory, read as float4.
// Backward, two launches, from the forward's scale*C and (m, l); each of q,
// k, v and g is read once and each of dq, dk and dv written once:
//   1. grad_q: grid (chunks of columns, B*h), 8 warps a block; a warp takes
//      16-column slices of q and g, staged by cp.async ahead of use. Per
//      slice: s = softmax_d(q) in shared memory, ds = (scale C) g and
//      dC' += s g^T as mma.sync m16n8k8 products in split TF32 (three TF32
//      products keep fp32 accuracy; scale*C's operands are split once a
//      block), and dq = s * (ds - sum_d s*ds) written from the products'
//      registers. The block's dC' goes to a partial; the last block of each
//      (b, h) to arrive (an atomic ticket) sums the chunks' in chunk order
//      (the same sum from run to run) and forms r[d] = sum_e dC'[d,e]
//      (scale C)[d,e], the softmax-N VJP's sum over N.
//   2. grad_kv: the same grid, a programmatic dependent launch of grad_q:
//      its blocks stage their first k and v slices and the statistics while
//      grad_q ends, then wait for dC' and r. Per slice: p = exp(k - m) / l,
//      dv = (scale / N) dC'^T p in split TF32, dp = dC' ((scale / N) v) as
//      an fmaf chain over e on the CUDA cores, dk = p * (dp - r); dk and dv
//      written. r is the same fmaf chain over (scale C): where dp = r in
//      exact arithmetic (N = 1, where dk vanishes) they are equal bit for
//      bit and dk is 0, not the rounding noise of two orders of summation.
// On an H100 the backward's passes run at 2.1-2.3 TB/s, and as fast with
// their arithmetic stripped (scripts/port/kernel_sweeps.py): the 16-column
// slices' staging sets their time; wider slices, deeper pipelines and
// narrower blocks were slower there.
// The scratch is allocated by the caller (la_workspace_floats,
// la_backward_workspace_floats), as are the backward's arrival counters.
//
// q, k, v and g may each have any batch stride; within a batch element they
// must be contiguous (head stride d*N, row stride N). out, dq, dk and dv are
// contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int D = 32;                      // dim_head
constexpr int TILE = 128;                  // columns staged per tile
constexpr int CHUNK = 4 * TILE;            // columns per block of pass 1
constexpr int CTX_THREADS = 256;           // threads of pass 1
constexpr int GROUP_COLS = TILE / 4;       // columns per thread group of pass 1
constexpr int COLS = 256;                  // columns (threads) per block of pass 3
constexpr int PARTIAL = 2 * D + D * D;     // m[D], l[D], P[D][D] per forward chunk

static_assert(4 * D * D <= D * (TILE + 1), "the reduction buffer reuses a staged tile");
static_assert(COLS == D * D / 4, "pass 3 loads a d x d matrix with one float4 per thread");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Thread t of a pass-1 block owns rows d0..d0+3 and columns e0..e0+3 of the
// d x d sum, over the quarter `grp` of the tile's columns.
struct Block4x4 {
  int grp, d0, e0;
  __device__ explicit Block4x4(int t) : grp(t / 64), d0((t % 64) / 8 * 4), e0((t % 8) * 4) {}
};

// acc[i][j] += sum over this thread's columns of a[d0+i][col] * b[e0+j][col]
__device__ __forceinline__ void accumulate_tile(float (&acc)[4][4], const float (&a)[D][TILE + 1],
                                                const float (&b)[D][TILE + 1], Block4x4 blk) {
  for (int col = blk.grp * GROUP_COLS; col < (blk.grp + 1) * GROUP_COLS; ++col) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[blk.d0 + i][col];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[blk.e0 + j][col];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Sums the four column groups' blocks into out[0 .. D*D), through `red`
// (4*D*D floats of shared memory no longer in use). Ends synchronised.
__device__ __forceinline__ void reduce_groups(const float (&acc)[4][4], float* red, Block4x4 blk,
                                              float* __restrict__ out) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[blk.grp * D * D + (blk.d0 + i) * D + blk.e0 + j] = acc[i][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < D * D; idx += CTX_THREADS)
    out[idx] = (red[idx] + red[D * D + idx]) + (red[2 * D * D + idx] + red[3 * D * D + idx]);
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(CTX_THREADS)
context_partials(const float* __restrict__ k, const float* __restrict__ v,
                 long long k_bstride, long long v_bstride, int heads, int n,
                 int n_chunks, float* __restrict__ partials) {
  // +1 column of padding: the rows read together in the contraction fall in
  // distinct banks
  __shared__ float ks[D][TILE + 1];
  __shared__ float vs[D][TILE + 1];
  __shared__ float m_run[D], l_run[D], fac[D];

  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  const float* kb = k + b * k_bstride + (long long)h * D * n;
  const float* vb = v + b * v_bstride + (long long)h * D * n;
  const int warp = t / 32, lane = t % 32;
  const Block4x4 blk(t);
  float acc[4][4] = {};

  if (t < D) {
    m_run[t] = -INFINITY;
    l_run[t] = 0.f;
  }
  const int start = chunk * CHUNK;
  const int end = min(start + CHUNK, n);
  for (int base = start; base < end; base += TILE) {
    __syncthreads();  // the previous tile is consumed; m_run/l_run initialised
    const int c = t % TILE;
    const bool valid = base + c < end;
    for (int row = t / TILE; row < D; row += CTX_THREADS / TILE) {
      // a column past the end contributes exp(-inf) = 0 to every sum
      ks[row][c] = valid ? kb[(long long)row * n + base + c] : -INFINITY;
      vs[row][c] = valid ? vb[(long long)row * n + base + c] : 0.f;
    }
    __syncthreads();
    // warp w owns rows 4w..4w+3: tile max, new running max, exp in place
    for (int i = 0; i < 4; ++i) {
      const int row = warp * 4 + i;
      float x[TILE / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        x[j] = ks[row][lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
      const float m_old = m_run[row];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: column base is valid
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        const float e = expf(x[j] - m_new);
        ks[row][lane + 32 * j] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float f = expf(m_old - m_new);  // 0 on the first tile
        fac[row] = f;
        l_run[row] = l_run[row] * f + s;
        m_run[row] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = fac[blk.d0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= f;
    }
    accumulate_tile(acc, ks, vs, blk);
  }
  float* out = partials + ((long long)bh * n_chunks + chunk) * PARTIAL;
  reduce_groups(acc, &ks[0][0], blk, out + 2 * D);
  if (t < D) {
    out[t] = m_run[t];
    out[D + t] = l_run[t];
  }
}

__global__ void __launch_bounds__(D * D)
combine_context(const float* __restrict__ partials, int n_chunks, int n, float scale,
                float* __restrict__ ctx, float* __restrict__ stats) {
  const int bh = blockIdx.x, t = threadIdx.x, d = t / D;
  const float* p = partials + (long long)bh * n_chunks * PARTIAL;
  float m = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, p[c * PARTIAL + d]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float* pc = p + c * PARTIAL;
    const float f = expf(pc[d] - m);
    l = fmaf(pc[D + d], f, l);
    acc = fmaf(pc[2 * D + t], f, acc);
  }
  ctx[(long long)bh * D * D + t] = acc * (scale / (l * (float)n));
  if (t % D == 0) {  // softmax_N(k) = exp(k - m) / l, for the backward
    stats[(long long)bh * 2 * D + d] = m;
    stats[(long long)bh * 2 * D + D + d] = l;
  }
}

// Loads column `col` of a (D, n) row-major matrix into x.
__device__ __forceinline__ void load_column(float (&x)[D], const float* base, int n) {
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = base[(long long)d * n];
}

// softmax over d, in place
__device__ __forceinline__ void softmax_d(float (&x)[D]) {
  float mx = -INFINITY;
#pragma unroll
  for (int d = 0; d < D; ++d) mx = fmaxf(mx, x[d]);
  float sum = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = expf(x[d] - mx);
    sum += x[d];
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] *= inv;
}

__global__ void __launch_bounds__(COLS)
apply_context(const float* __restrict__ q, long long q_bstride, int heads, int n,
              const float* __restrict__ ctx, float* __restrict__ out) {
  __shared__ float4 cs[D * D / 4];  // scale*C[d][e], e fastest
  const int bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  cs[t] = reinterpret_cast<const float4*>(ctx + (long long)bh * D * D)[t];
  __syncthreads();
  const int col = blockIdx.x * COLS + t;
  if (col >= n) return;
  float s[D];
  load_column(s, q + b * q_bstride + (long long)h * D * n + col, n);
  softmax_d(s);
  float* ob = out + (long long)bh * D * n + col;
#pragma unroll
  for (int e4 = 0; e4 < D / 4; ++e4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float4 c = cs[d * (D / 4) + e4];
      a.x = fmaf(c.x, s[d], a.x);
      a.y = fmaf(c.y, s[d], a.y);
      a.z = fmaf(c.z, s[d], a.z);
      a.w = fmaf(c.w, s[d], a.w);
    }
    ob[(long long)(4 * e4 + 0) * n] = a.x;
    ob[(long long)(4 * e4 + 1) * n] = a.y;
    ob[(long long)(4 * e4 + 2) * n] = a.z;
    ob[(long long)(4 * e4 + 3) * n] = a.w;
  }
}

// ----------------------------------------------------------------- backward

constexpr int WARPS = 8;                   // warps of a backward block
constexpr int BWD_THREADS = 32 * WARPS;
constexpr int W = 16;                      // columns of a warp's slice
constexpr int WP = W + 4;                  // row stride of a staged slice (floats): the A and
                                           // B^T fragment reads fall in 32 distinct banks
constexpr int NT = W / 8;                  // 8-column n-tiles (and k-steps) of a slice
constexpr int LPC = 32 / W;                // lanes of a column in the elementwise passes
constexpr int SLICE = D * WP;              // floats of one staged 32 x W slice
constexpr int STAGES = 2;                  // slices a warp has staged, the one in use included
constexpr int FRAG = 2 * 4 * 32 * 4;       // a 32 x 32 A operand: 2 m-tiles x 4 k-steps x 32
                                           // lanes x 4 values, one TF32 plane
constexpr int STAGE_FLOATS = WARPS * STAGES * 2 * SLICE;
constexpr int BWD_BLOCKS_PER_SM = 2;      // blocks an SM holds (shared memory, registers)
constexpr int BWD_MIN_BLOCKS = BWD_BLOCKS_PER_SM * 132;  // a block for each slot of the H100's 132 SMs

static_assert(WARPS * D * D <= STAGE_FLOATS, "the warps' dC' sums reuse the staged slices");
static_assert(W == 16 || W == 32, "a slice is one or two lanes a column");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies columns col0 .. col0 + W - 1 of the (D, n) row-major matrix src into the slice dst
// (D x WP), asynchronously, one warp; columns at or past n read as 0. VEC: n and the matrix's
// start are 16-byte multiples, so a row's W columns are 4 copies of 16 bytes.
template <bool VEC>
__device__ __forceinline__ void stage_slice(float* dst, const float* src, int n, int col0,
                                            int lane) {
  if (VEC) {  // W / 4 copies of 16 bytes a row; lane takes copy lane % (W / 4) of its rows
    constexpr int CPR = W / 4;
    const int j = lane % CPR, col = col0 + 4 * j;
    const bool valid = col < n;
#pragma unroll
    for (int i = 0; i < D * CPR / 32; ++i) {
      const int d = lane / CPR + (32 / CPR) * i;
      cp_async16(dst + d * WP + 4 * j, src + (long long)d * n + (valid ? col : 0), valid);
    }
  } else {
    const int j = lane % W, col = col0 + j;
    const bool valid = col < n;
#pragma unroll
    for (int i = 0; i < D / LPC; ++i) {
      const int d = lane / W + LPC * i;
      cp_async4(dst + d * WP + j, src + (long long)d * n + (valid ? col : 0), valid);
    }
  }
}

// The 32 x 32 row-major matrix m (transposed if `transpose`) as mma.sync m16n8k8 A operands in
// split TF32, by the block: for m-tile mt, k-step ks and lane l the four values a0 .. a3
// (tensor_core.cuh) at dst[((4 mt + ks) * 32 + l) * 4 + i], hi parts, and FRAG floats on, lo
// parts. A lane then reads each operand as one float4 a plane.
__device__ __forceinline__ void a_fragments(float* dst, const float* m, bool transpose) {
  for (int idx = threadIdx.x; idx < FRAG; idx += blockDim.x) {
    const int i = idx & 3, l = (idx >> 2) & 31, tile = idx >> 7;
    const int row = 16 * (tile >> 2) + (l >> 2) + 8 * (i & 1);
    const int col = 8 * (tile & 3) + (l & 3) + 4 * (i >> 1);
    const tc::Split sp = tc::split(transpose ? m[col * D + row] : m[row * D + col]);
    dst[idx] = __uint_as_float(sp.hi);
    dst[FRAG + idx] = __uint_as_float(sp.lo);
  }
}

// d += a b in split TF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi): a from a_fragments' planes,
// b as its hi and lo parts
__device__ __forceinline__ void mma_split(float (&d)[4], const float4& ah, const float4& al,
                                          const tc::Split& b0, const tc::Split& b1) {
  tc::mma_tf32(d, __float_as_uint(al.x), __float_as_uint(al.y), __float_as_uint(al.z),
               __float_as_uint(al.w), b0.hi, b1.hi);
  tc::mma_tf32(d, __float_as_uint(ah.x), __float_as_uint(ah.y), __float_as_uint(ah.z),
               __float_as_uint(ah.w), b0.lo, b1.lo);
  tc::mma_tf32(d, __float_as_uint(ah.x), __float_as_uint(ah.y), __float_as_uint(ah.z),
               __float_as_uint(ah.w), b0.hi, b1.hi);
}

__device__ __forceinline__ float4 frag(const float* plane, int mt, int ks, int lane) {
  return reinterpret_cast<const float4*>(plane)[(4 * mt + ks) * 32 + lane];
}

// Stores the two values of a D fragment row at column col (of n), 8 bytes at once where VEC
// makes that aligned and both columns exist
template <bool VEC>
__device__ __forceinline__ void store_pair(float* row, int col, int n, float a, float b) {
  if (VEC) {
    if (col < n) *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < n) row[col] = a;
    if (col + 1 < n) row[col + 1] = b;
  }
}

// Pass 1: q and g. Block (chunk, b*h) takes `cols` columns; warp w its 16-column slices w,
// w + WARPS, ... of them, staged by cp.async STAGES - 1 slices ahead. Per slice: s = softmax_d(q) in
// place, ds = (scale C) g and dC' += s g^T on the tensor cores, and dq = s * (ds - sum_d s*ds)
// written. The block's dC' (its warps' sums in warp order) goes to `partials`; the last block of
// b*h to arrive sums the chunks' in chunk order into dctx and forms r.
template <bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS_PER_SM)
grad_q(const float* __restrict__ q, const float* __restrict__ g, long long q_bstride,
       long long g_bstride, int heads, int n, int cols, int n_chunks, const float* __restrict__ ctx,
       float* __restrict__ dq, float* __restrict__ partials, float* __restrict__ dctx,
       float* __restrict__ r, unsigned* __restrict__ arrivals) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  float* cfr = smem;  // scale*C as A operands (row d, column e), hi and lo planes
  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = bh / heads, h = bh % heads;
  const float* qb = q + b * q_bstride + (long long)h * D * n;
  const float* gb = g + b * g_bstride + (long long)h * D * n;
  float* dqb = dq + (long long)bh * D * n;
  const int start = chunk * cols, slices = (min(start + cols, n) - start + W - 1) / W;
  float* st = smem + 2 * FRAG + warp * STAGES * 2 * SLICE;

  for (int i = 0; i < STAGES - 1; ++i) {  // the warp's first slices, one a stage but the last
    const int sl = warp + i * WARPS;
    if (sl < slices) {
      stage_slice<VEC>(st + i * 2 * SLICE, qb, n, start + sl * W, lane);
      stage_slice<VEC>(st + i * 2 * SLICE + SLICE, gb, n, start + sl * W, lane);
    }
    cp_async_commit();
  }
  a_fragments(cfr, ctx + (long long)bh * D * D, false);
  __syncthreads();

  float dc[2][4][4] = {};  // dC'[d][e] over this warp's columns: m-tile of d, n-tile of e
  for (int i = 0, sl = warp; sl < slices; ++i, sl += WARPS) {
    float* qs = st + (i % STAGES) * 2 * SLICE;
    const float* gs = qs + SLICE;
    const int ahead = sl + (STAGES - 1) * WARPS;
    if (ahead < slices) {
      float* nb = st + ((i + STAGES - 1) % STAGES) * 2 * SLICE;
      stage_slice<VEC>(nb, qb, n, start + ahead * W, lane);
      stage_slice<VEC>(nb + SLICE, gb, n, start + ahead * W, lane);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();

    {  // softmax over d of each column, in place: lane takes column lane % W, every LPC-th row
      const int j = lane % W, d0 = lane / W;
      float x[D / LPC], mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < D / LPC; ++k) {
        x[k] = qs[(d0 + LPC * k) * WP + j];
        mx = fmaxf(mx, x[k]);
      }
      if (LPC == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < D / LPC; ++k) {
        x[k] = expf(x[k] - mx);
        sum += x[k];
      }
      if (LPC == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      const float inv = 1.f / sum;
#pragma unroll
      for (int k = 0; k < D / LPC; ++k) qs[(d0 + LPC * k) * WP + j] = x[k] * inv;
    }
    __syncwarp();

    // ds[d][c] = sum_e (scale C)[d][e] g[e][c]: m-tiles of d, n-tiles of the slice's columns
    float ds[2][NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      tc::Split b0[NT], b1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b0[nt] = tc::split(gs[(8 * ks + tq) * WP + 8 * nt + gq]);
        b1[nt] = tc::split(gs[(8 * ks + tq + 4) * WP + 8 * nt + gq]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 ah = frag(cfr, mt, ks, lane), al = frag(cfr + FRAG, mt, ks, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_split(ds[mt][nt], ah, al, b0[nt], b1[nt]);
      }
    }
    // dq = s * (ds - sum_d s*ds): a lane holds rows gq (+8, +16, +24) of columns 2tq, 2tq + 1
    const int col0 = start + sl * W;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float2 sv[2][2];
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          sv[mt][hf] = *reinterpret_cast<const float2*>(qs + (16 * mt + 8 * hf + gq) * WP + 8 * nt + 2 * tq);
          dot0 = fmaf(sv[mt][hf].x, ds[mt][nt][2 * hf], dot0);
          dot1 = fmaf(sv[mt][hf].y, ds[mt][nt][2 * hf + 1], dot1);
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
        dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_pair<VEC>(dqb + (long long)(16 * mt + 8 * hf + gq) * n, col0 + 8 * nt + 2 * tq, n,
                          sv[mt][hf].x * (ds[mt][nt][2 * hf] - dot0),
                          sv[mt][hf].y * (ds[mt][nt][2 * hf + 1] - dot1));
    }
    // dC'[d][e] += sum_c s[d][c] g[e][c]: A = s (row d, k = column), B = g^T (k = column, n = e)
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      tc::Split a[2][4], bb[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[mt][i] = tc::split(qs[(16 * mt + gq + 8 * (i & 1)) * WP + 8 * ks + tq + 4 * (i >> 1)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bb[nt][0] = tc::split(gs[(8 * nt + gq) * WP + 8 * ks + tq]);
        bb[nt][1] = tc::split(gs[(8 * nt + gq) * WP + 8 * ks + tq + 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          tc::mma_tf32(dc[mt][nt], a[mt][0].lo, a[mt][1].lo, a[mt][2].lo, a[mt][3].lo, bb[nt][0].hi, bb[nt][1].hi);
          tc::mma_tf32(dc[mt][nt], a[mt][0].hi, a[mt][1].hi, a[mt][2].hi, a[mt][3].hi, bb[nt][0].lo, bb[nt][1].lo);
          tc::mma_tf32(dc[mt][nt], a[mt][0].hi, a[mt][1].hi, a[mt][2].hi, a[mt][3].hi, bb[nt][0].hi, bb[nt][1].hi);
        }
    }
    __syncwarp();  // the slice is read: the next iteration may stage into it
  }

  // pass 2 may launch once every block is here: its blocks stage k and v, then wait for this
  // grid (griddepcontrol.wait) before they read dC' and r
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its slices
  float* red = smem + 2 * FRAG;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp * D * D + (16 * mt + gq + 8 * (i >> 1)) * D + 8 * nt + 2 * tq + (i & 1)] = dc[mt][nt][i];
  __syncthreads();
  float* out = partials + ((long long)bh * n_chunks + chunk) * D * D;
  for (int idx = t; idx < D * D; idx += BWD_THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red[w * D * D + idx];
    out[idx] = acc;
  }

  // the last block of b*h to get here sums the chunks, in chunk order
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&arrivals[bh], 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pb = partials + (long long)bh * n_chunks * D * D;
  for (int i = t; i < D * D / 4; i += BWD_THREADS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // dC'[i / 8][4 (i % 8) ..]
    for (int c = 0; c < n_chunks; ++c) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(pb + (long long)c * D * D) + i);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    reinterpret_cast<float4*>(dctx + (long long)bh * D * D)[i] = acc;
    reinterpret_cast<float4*>(red)[i] = acc;
  }
  __syncthreads();
  // r[d] = sum_e dC'[d][e] (scale C)[d][e] by the fmaf chain over e that gives grad_kv's dp:
  // where the two are equal in exact arithmetic (N = 1, where dk vanishes) they are equal here
  if (t < D) {
    const float* cr = ctx + ((long long)bh * D + t) * D;
    float rd = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) rd = fmaf(red[t * D + e], cr[e], rd);
    r[(long long)bh * D + t] = rd;
  }
  if (t == 0) arrivals[bh] = 0;  // ready for the next call
}

// Pass 2: k and v. The same blocks and slices as pass 1. Per slice: p = exp(k - m) / l and w =
// (scale / N) v in place (p 0 past the end), dv = (scale / N) dC'^T p on the tensor cores in
// split TF32, dp = dC' w by an fmaf chain over e on the CUDA cores (the chain that gives pass 1's
// r, so that dp - r is exact where it vanishes), dk = p * (dp - r); dk and dv written. Launched
// as a programmatic dependent of pass 1: it stages its first slices and the softmax statistics
// before it waits for dC' and r. dctx and r are read through plain pointers: loads through a
// __restrict__ pointer to const may be hoisted above the wait.
template <bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS_PER_SM)
grad_kv(const float* __restrict__ k, const float* __restrict__ v, long long k_bstride,
        long long v_bstride, int heads, int n, int cols, const float* __restrict__ stats,
        const float* dctx, const float* r, float coef, float* __restrict__ dk,
        float* __restrict__ dv) {
  extern __shared__ __align__(16) float smem[];
  float* dtfr = smem;             // dC'^T as A operands (row e, column d), hi and lo planes
  float* dcs = smem + 2 * FRAG;   // dC'[d][e], e fastest
  float* m_s = dcs + D * D;
  float* linv_s = m_s + D;
  float* r_s = linv_s + D;
  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = bh / heads, h = bh % heads;
  const float* kb = k + b * k_bstride + (long long)h * D * n;
  const float* vb = v + b * v_bstride + (long long)h * D * n;
  float* dkb = dk + (long long)bh * D * n;
  float* dvb = dv + (long long)bh * D * n;
  const int start = chunk * cols, slices = (min(start + cols, n) - start + W - 1) / W;
  float* st = r_s + D + warp * STAGES * 2 * SLICE;

  for (int i = 0; i < STAGES - 1; ++i) {  // the warp's first slices, one a stage but the last
    const int sl = warp + i * WARPS;
    if (sl < slices) {
      stage_slice<VEC>(st + i * 2 * SLICE, kb, n, start + sl * W, lane);
      stage_slice<VEC>(st + i * 2 * SLICE + SLICE, vb, n, start + sl * W, lane);
    }
    cp_async_commit();
  }
  if (t < D) {
    m_s[t] = stats[(long long)bh * 2 * D + t];
    linv_s[t] = 1.f / stats[(long long)bh * 2 * D + D + t];
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // pass 1 complete, dC' and r visible
  const float* dcg = dctx + (long long)bh * D * D;
  a_fragments(dtfr, dcg, true);
  for (int i = t; i < D * D / 4; i += BWD_THREADS)
    reinterpret_cast<float4*>(dcs)[i] = reinterpret_cast<const float4*>(dcg)[i];
  if (t < D) r_s[t] = r[(long long)bh * D + t];
  __syncthreads();

  const int j = lane % W, d0 = lane / W;  // a lane's column of the slice, every LPC-th row
  for (int i = 0, sl = warp; sl < slices; ++i, sl += WARPS) {
    float* ps = st + (i % STAGES) * 2 * SLICE;
    float* ws = ps + SLICE;
    const int ahead = sl + (STAGES - 1) * WARPS;
    if (ahead < slices) {
      float* nb = st + ((i + STAGES - 1) % STAGES) * 2 * SLICE;
      stage_slice<VEC>(nb, kb, n, start + ahead * W, lane);
      stage_slice<VEC>(nb + SLICE, vb, n, start + ahead * W, lane);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int col0 = start + sl * W;
    const bool valid = col0 + j < n;
#pragma unroll
    for (int kk = 0; kk < D / LPC; ++kk) {  // p = softmax_N(k) from the forward's statistics; w
      const int d = d0 + LPC * kk;
      ps[d * WP + j] = valid ? expf(ps[d * WP + j] - m_s[d]) * linv_s[d] : 0.f;
      ws[d * WP + j] *= coef;
    }
    __syncwarp();

    // dv[e][c] = coef sum_d dC'[d][e] p[d][c]: A = dC'^T, B = p (k = d, n = c)
    float dva[2][NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      tc::Split p0[NT], p1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        p0[nt] = tc::split(ps[(8 * ks + tq) * WP + 8 * nt + gq]);
        p1[nt] = tc::split(ps[(8 * ks + tq + 4) * WP + 8 * nt + gq]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float4 th = frag(dtfr, mt, ks, lane), tl = frag(dtfr + FRAG, mt, ks, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_split(dva[mt][nt], th, tl, p0[nt], p1[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store_pair<VEC>(dvb + (long long)(16 * mt + 8 * hf + gq) * n, col0 + 8 * nt + 2 * tq, n,
                          dva[mt][nt][2 * hf] * coef, dva[mt][nt][2 * hf + 1] * coef);

    // dk[d][c] = p[d][c] (sum_e dC'[d][e] w[e][c] - r[d]): lane takes column j, its rows
    float w[D];
#pragma unroll
    for (int e = 0; e < D; ++e) w[e] = ws[e * WP + j];
#pragma unroll 4
    for (int kk = 0; kk < D / LPC; ++kk) {
      const int d = d0 + LPC * kk;
      const float4* row = reinterpret_cast<const float4*>(dcs + d * D);
      float dp = 0.f;
#pragma unroll
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 c = row[e4];
        dp = fmaf(c.x, w[4 * e4], dp);
        dp = fmaf(c.y, w[4 * e4 + 1], dp);
        dp = fmaf(c.z, w[4 * e4 + 2], dp);
        dp = fmaf(c.w, w[4 * e4 + 3], dp);
      }
      if (valid) dkb[(long long)d * n + col0 + j] = ps[d * WP + j] * (dp - r_s[d]);
    }
    __syncwarp();  // the slice is read: the next iteration may stage into it
  }
}

// Columns a backward block takes: whole slices of every warp (128 columns), as few as give at
// least BWD_MIN_BLOCKS blocks where N allows
int bwd_cols(int bh, int n) {
  const int unit = W * WARPS, units = (n + unit - 1) / unit;
  const int per = ((long long)units * bh + BWD_MIN_BLOCKS - 1) / BWD_MIN_BLOCKS;
  return unit * (per > 0 ? per : 1);
}

int bwd_chunks(int bh, int n) {
  const int cols = bwd_cols(bh, n);
  return (n + cols - 1) / cols;
}

constexpr int GRAD_Q_SMEM = (2 * FRAG + STAGE_FLOATS) * 4;
constexpr int GRAD_KV_SMEM = (2 * FRAG + D * D + 3 * D + STAGE_FLOATS) * 4;

template <bool VEC>
int launch_backward(const float* q, const float* k, const float* v, const float* g,
                    const float* ctx, const float* stats, float* dq, float* dk, float* dv,
                    float* workspace, unsigned* arrivals, long long q_bstride, long long k_bstride,
                    long long v_bstride, long long g_bstride, int batch, int heads, int n,
                    float scale, cudaStream_t s) {
  const int bh = batch * heads, cols = bwd_cols(bh, n), n_chunks = bwd_chunks(bh, n);
  float* partials = workspace;
  float* dctx = partials + (long long)bh * n_chunks * D * D;  // 16-byte aligned
  float* r = dctx + (long long)bh * D * D;
  cudaError_t err = cudaFuncSetAttribute(grad_q<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GRAD_Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kv<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GRAD_KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, bh);
  grad_q<VEC><<<grid, BWD_THREADS, GRAD_Q_SMEM, s>>>(q, g, q_bstride, g_bstride, heads, n, cols,
                                                     n_chunks, ctx, dq, partials, dctx, r,
                                                     arrivals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a programmatic dependent launch: pass 2's blocks may start before pass 1 ends (Hopper)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = GRAD_KV_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grad_kv<VEC>, k, v, k_bstride, v_bstride, heads, n, cols, stats,
                           static_cast<const float*>(dctx), static_cast<const float*>(r),
                           scale / (float)n, dk, dv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int chunks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

}  // namespace

extern "C" {

// Floats of scratch that la_forward_f32 needs for B*h = bh and N = n.
long long la_workspace_floats(int bh, int n) { return (long long)bh * chunks_of(n) * PARTIAL; }

// Launches the three forward passes on `stream`; returns cudaGetLastError()
// after the first launch that fails, else 0. Pointers are device pointers.
// Besides out (B, h, d, N) it writes ctx = scale*C (B*h*d*d floats, 16-byte
// aligned) and stats = (m, l) of softmax_N(k) (B*h*2*d floats), which the
// backward reads. The workspace holds la_workspace_floats(batch * heads, n).
int la_forward_f32(const float* q, const float* k, const float* v, float* out, float* ctx,
                   float* stats, float* workspace, long long q_bstride, long long k_bstride,
                   long long v_bstride, int batch, int heads, int n, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, n_chunks = chunks_of(n);
  context_partials<<<dim3(n_chunks, bh), CTX_THREADS, 0, s>>>(k, v, k_bstride, v_bstride, heads,
                                                               n, n_chunks, workspace);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_context<<<bh, D * D, 0, s>>>(workspace, n_chunks, n, scale, ctx, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_context<<<dim3((n + COLS - 1) / COLS, bh), COLS, 0, s>>>(q, q_bstride, heads, n, ctx, out);
  return (int)cudaGetLastError();
}

// Floats of scratch that la_backward_f32 needs for B*h = bh and N = n: the chunks' dC' partials,
// dC' and r.
long long la_backward_workspace_floats(int bh, int n) {
  return (long long)bh * bwd_chunks(bh, n) * D * D + (long long)bh * D * D + (long long)bh * D;
}

// Launches the two backward passes on `stream`; returns the first CUDA error, else 0. ctx and
// stats are the forward's outputs for the same q, k, v and scale; g is the gradient of out.
// Writes dq, dk, dv (B, h, d, N), contiguous. arrivals holds batch * heads counters that are 0,
// and are 0 again when the passes end.
int la_backward_f32(const float* q, const float* k, const float* v, const float* g,
                    const float* ctx, const float* stats, float* dq, float* dk, float* dv,
                    float* workspace, unsigned* arrivals, long long q_bstride, long long k_bstride,
                    long long v_bstride, long long g_bstride, int batch, int heads, int n,
                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && q_bstride % 4 == 0 && k_bstride % 4 == 0 && v_bstride % 4 == 0 &&
                   g_bstride % 4 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)) % 16 == 0;
  return (vec ? launch_backward<true> : launch_backward<false>)(
      q, k, v, g, ctx, stats, dq, dk, dv, workspace, arrivals, q_bstride, k_bstride, v_bstride,
      g_bstride, batch, heads, n, scale, s);
}

}  // extern "C"
