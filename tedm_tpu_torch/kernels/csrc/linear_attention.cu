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
// Forward: the columns of a (b, h) are cut into shares, one a block. A block stages tiles of
// TW = 128 columns of k and v (each row a contiguous run) by cp.async a tile ahead of use, and
// each of its 8 warps takes a 16-column slice of each tile. Per slice: lane d takes row d of k,
// the slice's row max, exp(k - m) in place and the factor exp(m_old - m) by which its running
// sum l and the context P[d][e] = sum exp(k[d,c] - m[d]) v[e,c] are rescaled (the online
// softmax); then P += E V^T as mma.sync m16n8k8 products in split TF32, from 0 for each slice,
// added to P by an fmaf (the tensor cores' own accumulation rounds toward zero). A warp's first
// column is added by an fmaf, not on the tensor cores: the split-TF32 product of 1 and v keeps
// 22 of v's 24 bits, and at N = 1 scale*C must be (scale / N) v bit for bit, which the
// backward's dk = 0 there needs (see below). The warps' (m, l, P) are merged in warp order, the
// shares' in share order (the same sums from run to run), into scale*C = scale P / (N l) and the
// statistics (m, l); then q is staged the same way, and out = (scale C)^T softmax_d(q) computed
// as split-TF32 products, staged in the slice's place and written 16 bytes a lane. Two routes,
// by B*h and N (forward_route):
//   - la_cluster, one launch, for N <= 2 TW (and N <= 8 TW at B*h > 33): a thread-block
//     cluster of 2 CTAs for each (b, h), a share for each. The CTAs merge their (m, l, P)
//     through distributed shared memory in rank order, each CTA all of them (rank 0 writes
//     scale*C and the statistics), while their first q tile lands; then each applies the
//     context to its own share.
//   - context_chunks + apply_chunks, two launches, above: blocks of chunks of columns, two an
//     SM, write their (m, l, P) to a workspace; the last block of each (b, h) to arrive (an
//     atomic ticket, which it resets) merges the chunks in chunk order. apply_chunks, a
//     programmatic dependent launch, stages its first q tile while context_chunks ends; its
//     blocks take fewer columns, three an SM, as its registers allow.
// scripts/port/kernel_sweeps.py times both routes, clusters of 1 to 8 CTAs (CLUSTER), slice
// widths, warps, stages and blocks an SM, each in a copy of this source with its constants
// replaced and its route forced, at the 8 path shapes (PERF.md section 6): clusters of 2 win at
// N = 256, and at N = 1024 at batch 16, where the two launches' merge through device memory
// costs more than the work; the two launches above, where one CTA a cluster member leaves SMs
// idle or runs in two rounds.
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
// la_backward_workspace_floats), as are the arrival counters.
//
// q, k, v and g may each have any batch stride; within a batch element they
// must be contiguous (head stride d*N, row stride N). out, dq, dk and dv are
// contiguous.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 32;                      // dim_head
constexpr int FRAG = 2 * 4 * 32 * 4;       // a 32 x 32 A operand: 2 m-tiles x 4 k-steps x 32
                                           // lanes x 4 values, one TF32 plane

// ------------------------------------------------------------------ staging and products

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

// ------------------------------------------------------------------ forward

constexpr int FWARPS = 8;                   // warps of a forward block
constexpr int FTHREADS = 32 * FWARPS;
constexpr int FW = 16;                      // columns of a warp's slice of a tile
constexpr int TW = FW * FWARPS;             // columns of a block's tile
constexpr int TWP = TW + 4;                 // row stride of a staged tile (floats): a lane's row
                                            // as float4s and the A and B fragment reads of the
                                            // context are free of bank conflicts
constexpr int FNT = FW / 8;                 // 8-column k-steps (and n-tiles) of a slice
constexpr int FLPC = 32 / FW;               // lanes of a column in the softmax over d
constexpr int FTILE = D * TWP;              // floats of one staged 32 x TW tile
constexpr int FSTAGES = 2;                  // tiles the block has staged, the one in use included
constexpr int RING = FSTAGES * 2 * FTILE;   // the block's ring: FSTAGES slots of a k and a v tile;
                                            // in the apply its first half holds q's slots
constexpr int PART = 2 * D + D * D;         // (m[d], l[d], P[d][e]) of a share of the columns
constexpr int FWD_BLOCKS_PER_SM = 2;        // blocks an SM holds (registers, shared memory)
constexpr int SMS = 132;                    // the H100's SMs
constexpr int FWD_MIN_BLOCKS = FWD_BLOCKS_PER_SM * SMS;  // a block for each slot
// apply_chunks holds fewer registers and less shared memory: 24 warps an SM
constexpr int APPLY_BLOCKS_PER_SM = FWARPS < 24 ? 24 / FWARPS : 1;
constexpr int APPLY_MIN_BLOCKS = APPLY_BLOCKS_PER_SM * SMS;
constexpr int CLUSTER = 2;                  // CTAs of la_cluster's cluster, one a share

static_assert(FWARPS * PART + FWARPS * D <= RING,
              "the warps' partials and merge factors reuse the ring");
static_assert((FSTAGES - 1) * FTILE + CLUSTER * D <= RING,
              "the cluster's merge factors follow q's first slots");
static_assert(CLUSTER >= 1 && CLUSTER <= 8, "a portable cluster size");
static_assert(FW == 16 || FW == 32, "a slice is one or two lanes a column");

// d += a b in split TF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi), a and b as their hi and lo parts
__device__ __forceinline__ void mma_split(float (&d)[4], const tc::Split (&a)[4],
                                          const tc::Split& b0, const tc::Split& b1) {
  tc::mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  tc::mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  tc::mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// A warp's online softmax over N and context over the slices it has taken: m and l of row `lane`
// (the row max of k and the sum of exp(k - m)), and P[d][e] = sum_c exp(k[d,c] - m[d]) v[e,c] in
// the mma.sync D layout, p[mt][nt][i] at row 16 mt + gq + 8 (i >> 1), column 8 nt + 2 tq + (i & 1).
struct Context {
  float m = -INFINITY, l = 0.f;
  float p[2][4][4] = {};
};

__device__ __forceinline__ int tiles_of(int start, int end) {
  return end > start ? (end - start + TW - 1) / TW : 0;
}

// Stages the tile of columns t0 .. t0 + TW - 1 of the (D, n) row-major matrix src into dst (D
// rows of TWP floats), asynchronously, by the block: 16-byte copies where VEC (n and the
// matrix's start 16-byte multiples), else 4-byte ones, consecutive threads on consecutive
// columns of a row, so that a warp reads a contiguous run; columns at or past n read as 0.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int n, int t0) {
  constexpr int PER = VEC ? 4 : 1, CPR = TW / PER;  // floats a copy, copies a row
#pragma unroll
  for (int i = 0; i < D * CPR / FTHREADS; ++i) {
    const int c = threadIdx.x + FTHREADS * i, d = c / CPR, j = PER * (c % CPR), col = t0 + j;
    const bool valid = col < n;
    const float* from = src + (long long)d * n + (valid ? col : 0);
    if (VEC)
      cp_async16(dst + d * TWP + j, from, valid);
    else
      cp_async4(dst + d * TWP + j, from, valid);
  }
}

// Folds the warp's slices of the columns [start, end), columns warp * FW .. of each tile of TW,
// into cx; the tiles staged by cp.async FSTAGES - 1 ahead into the block's ring. Per slice: lane
// d takes row d of k, the new row max, exp(k - m) in place (0 past end) and the factor exp(m_old
// - m) that rescales l and P; then P += E V^T on the tensor cores in split TF32, the warp's first
// column by an fmaf. Called by the whole block; returns with every copy landed and every warp
// done with the ring.
template <bool VEC>
__device__ __forceinline__ void context_tiles(Context& cx, const float* kb, const float* vb, int n,
                                              int start, int end, float* ring, int warp,
                                              int lane) {
  const int gq = lane >> 2, tq = lane & 3, tiles = tiles_of(start, end);
  for (int i = 0; i < FSTAGES - 1; ++i) {  // the first tiles, one a stage but the last
    if (i < tiles) {
      stage_tile<VEC>(ring + i * 2 * FTILE, kb, n, start + i * TW);
      stage_tile<VEC>(ring + i * 2 * FTILE + FTILE, vb, n, start + i * TW);
    }
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    const int ahead = it + FSTAGES - 1;
    if (ahead < tiles) {
      float* nb = ring + (ahead % FSTAGES) * 2 * FTILE;
      stage_tile<VEC>(nb, kb, n, start + ahead * TW);
      stage_tile<VEC>(nb + FTILE, vb, n, start + ahead * TW);
    }
    cp_async_commit();
    cp_async_wait<FSTAGES - 1>();
    __syncthreads();  // the tile has landed, every thread's copies
    const int col0 = start + it * TW + warp * FW;
    if (col0 < end) {
      float* ks = ring + (it % FSTAGES) * 2 * FTILE + warp * FW;
      const float* vs = ks + FTILE;
      float4* row = reinterpret_cast<float4*>(ks + lane * TWP);
      float x[FW];
#pragma unroll
      for (int j = 0; j < FW / 4; ++j) {
        const float4 u = row[j];
        x[4 * j] = u.x;
        x[4 * j + 1] = u.y;
        x[4 * j + 2] = u.z;
        x[4 * j + 3] = u.w;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FW; ++j)
        if (col0 + j < end) mx = fmaxf(mx, x[j]);
      const float m_new = fmaxf(cx.m, mx);  // finite: column col0 is in [start, end)
      const float f = expf(cx.m - m_new);   // 0 on the warp's first slice
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < FW; ++j) {
        x[j] = col0 + j < end ? expf(x[j] - m_new) : 0.f;
        sum += x[j];
      }
      // the warp's first column is added to P by an fmaf below, not on the tensor cores: the
      // split-TF32 product of 1 and v keeps 22 of v's 24 bits, and at N = 1 (p = 1) scale*C must
      // be (scale / N) v bit for bit
      const bool first = cx.m == -INFINITY;  // the same in every lane
      const float e0 = x[0];
      if (first) x[0] = 0.f;
#pragma unroll
      for (int j = 0; j < FW / 4; ++j)
        row[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      cx.l = fmaf(cx.l, f, sum);
      cx.m = m_new;
      __syncwarp();

      // P[d][e] = P[d][e] f[d] + sum_c E[d][c] V[e][c]: A = E (row d, k = column), B = V^T (k =
      // column, n = e). The slice's products start from 0 and are added to P by an fmaf: the
      // tensor cores' own accumulation rounds toward zero, and a chain of them over all of a
      // share drifts by some 2^-24 of P for each.
      float sp[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < FNT; ++kk) {
        tc::Split a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[mt][i] =
                tc::split(ks[(16 * mt + gq + 8 * (i & 1)) * TWP + 8 * kk + tq + 4 * (i >> 1)]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = tc::split(vs[(8 * nt + gq) * TWP + 8 * kk + tq]);
          b[nt][1] = tc::split(vs[(8 * nt + gq) * TWP + 8 * kk + tq + 4]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_split(sp[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + 8 * hf + gq;                  // a row of P this lane holds
          const float fr = __shfl_sync(0xffffffffu, f, r);      // its factor
          const float er = __shfl_sync(0xffffffffu, e0, r);     // its first column's exp
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float s = sp[mt][nt][2 * hf + j];
              const float add = first ? fmaf(er, vs[(8 * nt + 2 * tq + j) * TWP], s) : s;
              cx.p[mt][nt][2 * hf + j] = fmaf(cx.p[mt][nt][2 * hf + j], fr, add);
            }
        }
    }
    __syncthreads();  // every warp is done with the tile: the next iteration may stage into it
  }
  cp_async_wait<0>();
}

// cx as a partial (m, l, P) of PART floats
__device__ __forceinline__ void store_context(const Context& cx, float* part, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  part[lane] = cx.m;
  part[D + lane] = cx.l;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[2 * D + (16 * mt + gq + 8 * (i >> 1)) * D + 8 * nt + 2 * tq + (i & 1)] =
            cx.p[mt][nt][i];
}

template <bool GLOBAL>
__device__ __forceinline__ float load1(const float* p) {
  return GLOBAL ? __ldcg(p) : *p;
}
template <bool GLOBAL>
__device__ __forceinline__ float4 load4(const float* p) {
  return GLOBAL ? __ldcg(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p);
}

// Merges `count` partials in order into out, by the block: m = max_c m_c, f_c = exp(m_c - m) (0
// for a partial of no columns, m_c = -inf), l = sum_c l_c f_c and P = sum_c P_c f_c, each an fmaf
// chain in c. part(c) points at partial c, 16-byte aligned; GLOBAL: in device memory, written by
// other blocks of the grid, read through L2. fac is count * D floats of shared memory.
template <bool GLOBAL, class Part>
__device__ __forceinline__ void merge_parts(int count, Part part, float* fac, float* out) {
  const int t = threadIdx.x;
  if (t < D) {
    float m = -INFINITY;
    for (int c = 0; c < count; ++c) m = fmaxf(m, load1<GLOBAL>(part(c) + t));
    float l = 0.f;
    for (int c = 0; c < count; ++c) {
      const float mc = load1<GLOBAL>(part(c) + t);
      const float f = mc == -INFINITY ? 0.f : expf(mc - m);
      fac[c * D + t] = f;
      l = fmaf(load1<GLOBAL>(part(c) + D + t), f, l);
    }
    out[t] = m;
    out[D + t] = l;
  }
  __syncthreads();
  for (int i = t; i < D * D / 4; i += blockDim.x) {  // P[d][4 (i % 8) ..], d = i / 8
    const float* fd = fac + i / (D / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < count; ++c) {
      const float4 p = load4<GLOBAL>(part(c) + 2 * D + 4 * i);
      const float f = fd[c * D];
      acc.x = fmaf(p.x, f, acc.x);
      acc.y = fmaf(p.y, f, acc.y);
      acc.z = fmaf(p.z, f, acc.z);
      acc.w = fmaf(p.w, f, acc.w);
    }
    reinterpret_cast<float4*>(out + 2 * D)[i] = acc;
  }
}

// P of a merged partial into scale*C[d][e] = P[d][e] * (scale / (l[d] * n)), in place
__device__ __forceinline__ void scale_context(float* merged, float scale, int n) {
  for (int i = threadIdx.x; i < D * D; i += blockDim.x)
    merged[2 * D + i] *= scale / (merged[D + i / D] * (float)n);
}

// scale*C and the statistics (m, l) of a merged partial to (b, h)'s rows of ctx and stats
__device__ __forceinline__ void write_context(const float* merged, float* ctx, float* stats,
                                              int bh) {
  for (int i = threadIdx.x; i < D * D / 4; i += blockDim.x)
    reinterpret_cast<float4*>(ctx + (long long)bh * D * D)[i] =
        reinterpret_cast<const float4*>(merged + 2 * D)[i];
  if (threadIdx.x < 2 * D) stats[(long long)bh * 2 * D + threadIdx.x] = merged[threadIdx.x];
}

// Stages the first FSTAGES - 1 tiles of q in [start, end) into qring (slots of FTILE), by the block
template <bool VEC>
__device__ __forceinline__ void stage_first_q(float* qring, const float* qb, int n, int start,
                                              int end) {
  const int tiles = tiles_of(start, end);
  for (int i = 0; i < FSTAGES - 1; ++i) {
    if (i < tiles) stage_tile<VEC>(qring + i * FTILE, qb, n, start + i * TW);
    cp_async_commit();
  }
}

// Writes the staged slice src (D rows of TWP floats) to columns col0 .. of the (D, n) row-major
// matrix dst, those below end: 16 bytes a lane where VEC, so that a warp writes whole runs of a
// row; else a lane a column.
template <bool VEC>
__device__ __forceinline__ void store_slice(const float* src, float* dst, int n, int col0, int end,
                                            int lane) {
  if (VEC) {
    constexpr int CPR = FW / 4;  // 16-byte runs of a row
    const int j = lane % CPR, col = col0 + 4 * j;
#pragma unroll
    for (int i = 0; i < D * CPR / 32; ++i) {
      const int d = lane / CPR + (32 / CPR) * i;
      if (col < end)
        *reinterpret_cast<float4*>(dst + (long long)d * n + col) =
            *reinterpret_cast<const float4*>(src + d * TWP + 4 * j);
    }
  } else {
    const int j = lane % FW, col = col0 + j;
#pragma unroll
    for (int i = 0; i < D / FLPC; ++i) {
      const int d = lane / FW + FLPC * i;
      if (col < end) dst[(long long)d * n + col] = src[d * TWP + j];
    }
  }
}

// out = (scale C)^T softmax_d(q) over the warp's slices of [start, end), columns warp * FW .. of
// each tile, the first FSTAGES - 1 tiles staged by stage_first_q: per slice, s = softmax_d(q) in
// place, then the product with cfr (scale C transposed, from a_fragments) in split TF32, staged in
// the slice's place and written. Called by the whole block.
template <bool VEC>
__device__ __forceinline__ void apply_tiles(float* qring, const float* qb, float* ob, int n,
                                            int start, int end, const float* cfr, int warp,
                                            int lane) {
  const int gq = lane >> 2, tq = lane & 3, tiles = tiles_of(start, end);
  for (int it = 0; it < tiles; ++it) {
    const int ahead = it + FSTAGES - 1;
    if (ahead < tiles)
      stage_tile<VEC>(qring + (ahead % FSTAGES) * FTILE, qb, n, start + ahead * TW);
    cp_async_commit();
    cp_async_wait<FSTAGES - 1>();
    __syncthreads();  // the tile has landed, every thread's copies
    const int col0 = start + it * TW + warp * FW;
    if (col0 < end) {
      float* qs = qring + (it % FSTAGES) * FTILE + warp * FW;
      {  // softmax over d of each column, in place: lane takes column lane % FW, every FLPC-th row
        const int j = lane % FW, d0 = lane / FW;
        float x[D / FLPC], mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < D / FLPC; ++k) {
          x[k] = qs[(d0 + FLPC * k) * TWP + j];
          mx = fmaxf(mx, x[k]);
        }
        if (FLPC == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < D / FLPC; ++k) {
          x[k] = expf(x[k] - mx);
          sum += x[k];
        }
        if (FLPC == 2) sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const float inv = 1.f / sum;
#pragma unroll
        for (int k = 0; k < D / FLPC; ++k) qs[(d0 + FLPC * k) * TWP + j] = x[k] * inv;
      }
      __syncwarp();

      // out[e][c] = sum_d (scale C)[d][e] s[d][c]: m-tiles of e, n-tiles of the slice's columns
      float o[2][FNT][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        tc::Split b0[FNT], b1[FNT];
#pragma unroll
        for (int nt = 0; nt < FNT; ++nt) {
          b0[nt] = tc::split(qs[(8 * ks + tq) * TWP + 8 * nt + gq]);
          b1[nt] = tc::split(qs[(8 * ks + tq + 4) * TWP + 8 * nt + gq]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float4 ah = frag(cfr, mt, ks, lane), al = frag(cfr + FRAG, mt, ks, lane);
#pragma unroll
          for (int nt = 0; nt < FNT; ++nt) mma_split(o[mt][nt], ah, al, b0[nt], b1[nt]);
        }
      }
      __syncwarp();  // s is read: the slice takes out, to be written a row of columns at a time
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int nt = 0; nt < FNT; ++nt)
            *reinterpret_cast<float2*>(qs + (16 * mt + 8 * hf + gq) * TWP + 8 * nt + 2 * tq) =
                make_float2(o[mt][nt][2 * hf], o[mt][nt][2 * hf + 1]);
      __syncwarp();
      store_slice<VEC>(qs, ob, n, col0, end, lane);
    }
    __syncthreads();  // every warp is done with the tile: the next iteration may stage into it
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One launch: a cluster of CTAs for each (b, h) = blockIdx.y, CTA `rank` taking the columns
// [rank * share, (rank + 1) * share). Its warps fold their slices of k and v into their (m, l,
// P), which the CTA merges in warp order into its partial; the CTAs' partials are merged in rank
// order through distributed shared memory, by every CTA, while its first q slices land; then each
// CTA applies scale*C to its share of q.
template <bool VEC>
__global__ void __launch_bounds__(FTHREADS, FWD_BLOCKS_PER_SM)
la_cluster(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           long long q_bstride, long long k_bstride, long long v_bstride, int heads, int n,
           int share, float scale, float* __restrict__ out, float* __restrict__ ctx,
           float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  float* cpart = smem + RING;           // this CTA's partial, read by the cluster
  float* merged = cpart + PART;         // every CTA's, merged; then scale*C
  float* cfr = merged + PART;           // scale*C transposed as A operands, hi and lo planes
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = bh / heads, h = bh % heads;
  const long long head = (long long)h * D * n;
  const int start = min(rank * share, n), end = min(start + share, n);

  Context cx;
  context_tiles<VEC>(cx, k + b * k_bstride + head, v + b * v_bstride + head, n, start, end, smem,
                     warp, lane);
  store_context(cx, smem + warp * PART, lane);  // the warps' partials, in the ring
  __syncthreads();
  merge_parts<false>(FWARPS, [&](int w) { return smem + w * PART; }, smem + FWARPS * PART, cpart);
  __syncthreads();
  const float* qb = q + b * q_bstride + head;
  stage_first_q<VEC>(smem, qb, n, start, end);
  cluster_arrive();  // this CTA's partial is written ...
  cluster_wait();    // ... and every CTA's is
  merge_parts<false>(CLUSTER, [&](int r) { return cluster.map_shared_rank(cpart, r); },
                     smem + (FSTAGES - 1) * FTILE, merged);
  cluster_arrive();  // done reading the other CTAs' partials; waited for before exit
  __syncthreads();
  scale_context(merged, scale, n);
  __syncthreads();
  if (rank == 0) write_context(merged, ctx, stats, bh);
  a_fragments(cfr, merged + 2 * D, true);
  __syncthreads();
  apply_tiles<VEC>(smem, qb, out + (long long)bh * D * n, n, start, end, cfr, warp, lane);
  cluster_wait();  // no CTA leaves while another may still read its partial
}

// Two launches, 1: block (chunk, b*h) folds the columns [chunk * cols, (chunk + 1) * cols) into
// a partial, its warps' merged in warp order, written to `partials`; the last block of b*h to
// arrive merges the chunks' in chunk order into scale*C and the statistics and resets its ticket.
template <bool VEC>
__global__ void __launch_bounds__(FTHREADS, FWD_BLOCKS_PER_SM)
context_chunks(const float* __restrict__ k, const float* __restrict__ v, long long k_bstride,
               long long v_bstride, int heads, int n, int cols, int n_chunks, float scale,
               float* __restrict__ partials, float* __restrict__ ctx, float* __restrict__ stats,
               unsigned* __restrict__ arrivals) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  float* merged = smem + RING;
  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = bh / heads, h = bh % heads;
  const long long head = (long long)h * D * n;
  const int start = chunk * cols, end = min(start + cols, n);

  Context cx;
  context_tiles<VEC>(cx, k + b * k_bstride + head, v + b * v_bstride + head, n, start, end, smem,
                     warp, lane);
  // apply_chunks may launch once every block is here: its blocks stage q, then wait for this
  // grid (griddepcontrol.wait) before they read scale*C
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  store_context(cx, smem + warp * PART, lane);  // the warps' partials, in the ring
  __syncthreads();
  float* part = partials + ((long long)bh * n_chunks + chunk) * PART;
  merge_parts<false>(FWARPS, [&](int w) { return smem + w * PART; }, smem + FWARPS * PART, part);

  // the last block of b*h to get here merges the chunks, in chunk order
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&arrivals[bh], 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pb = partials + (long long)bh * n_chunks * PART;
  merge_parts<true>(n_chunks, [&](int c) { return pb + (long long)c * PART; }, smem, merged);
  __syncthreads();
  scale_context(merged, scale, n);
  __syncthreads();
  write_context(merged, ctx, stats, bh);
  if (t == 0) arrivals[bh] = 0;  // ready for the next call
}

// Two launches, 2: block (chunk, b*h) applies scale*C to its columns of q, in chunks of its own
// (finer than context_chunks'). A programmatic dependent of context_chunks: it stages its first q
// tile before it waits for scale*C, which it reads through a plain pointer (loads through a
// __restrict__ pointer to const may be hoisted above the wait).
template <bool VEC>
__global__ void __launch_bounds__(FTHREADS, APPLY_BLOCKS_PER_SM)
apply_chunks(const float* __restrict__ q, long long q_bstride, int heads, int n, int cols,
             const float* ctx, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* cfr = smem + FSTAGES * FTILE;
  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int b = bh / heads, h = bh % heads;
  const int start = chunk * cols, end = min(start + cols, n);
  const float* qb = q + b * q_bstride + (long long)h * D * n;
  stage_first_q<VEC>(smem, qb, n, start, end);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // context_chunks complete, scale*C visible
  a_fragments(cfr, ctx + (long long)bh * D * D, true);
  __syncthreads();
  apply_tiles<VEC>(smem, qb, out + (long long)bh * D * n, n, start, end, cfr, warp, lane);
}

constexpr int CLUSTER_SMEM = (RING + 2 * PART + 2 * FRAG) * 4;
constexpr int CHUNKS_SMEM = (RING + PART) * 4;
constexpr int APPLY_SMEM = (FSTAGES * FTILE + 2 * FRAG) * 4;

// Columns a block of the two-launch route takes: whole tiles, as few as give at least min_blocks
// blocks where N allows (context_chunks: FWD_MIN_BLOCKS; apply_chunks: APPLY_MIN_BLOCKS)
int fwd_cols(int bh, int n, int min_blocks) {
  const int units = (n + TW - 1) / TW;
  const int per = ((long long)units * bh + min_blocks - 1) / min_blocks;
  return TW * (per > 0 ? per : 1);
}

int fwd_chunks(int bh, int n, int min_blocks) {
  const int cols = fwd_cols(bh, n, min_blocks);
  return (n + cols - 1) / cols;
}

// The forward's route for B*h = bh and N = n: CLUSTER for la_cluster, or 0 for the two launches.
// The cluster where the two launches' merge through device memory costs more than the work: a
// share of one tile, or of up to 4 where the 2 bh CTAs take more than half the SMs
// (scripts/port/kernel_sweeps.py)
int forward_route(int bh, int n) {
  return n <= 2 * TW || (n <= 8 * TW && 4 * bh > SMS) ? CLUSTER : 0;
}

template <bool VEC>
int launch_cluster(const float* q, const float* k, const float* v, float* out, float* ctx,
                   float* stats, long long q_bstride, long long k_bstride, long long v_bstride,
                   int bh, int heads, int n, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(la_cluster<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CLUSTER_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int share = ((n + CLUSTER - 1) / CLUSTER + 3) / 4 * 4;  // 16-byte runs stay whole
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, bh);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = CLUSTER_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, la_cluster<VEC>, q, k, v, q_bstride, k_bstride, v_bstride, heads,
                           n, share, scale, out, ctx, stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_chunks(const float* q, const float* k, const float* v, float* out, float* ctx,
                  float* stats, float* workspace, unsigned* arrivals, long long q_bstride,
                  long long k_bstride, long long v_bstride, int bh, int heads, int n, float scale,
                  cudaStream_t s) {
  const int cols = fwd_cols(bh, n, FWD_MIN_BLOCKS), n_chunks = fwd_chunks(bh, n, FWD_MIN_BLOCKS);
  const int apply_cols = fwd_cols(bh, n, APPLY_MIN_BLOCKS);
  cudaError_t err = cudaFuncSetAttribute(context_chunks<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNKS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(apply_chunks<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             APPLY_SMEM);
  if (err != cudaSuccess) return (int)err;
  context_chunks<VEC><<<dim3(n_chunks, bh), FTHREADS, CHUNKS_SMEM, s>>>(
      k, v, k_bstride, v_bstride, heads, n, cols, n_chunks, scale, workspace, ctx, stats, arrivals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a programmatic dependent launch: apply_chunks's blocks may start before context_chunks ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fwd_chunks(bh, n, APPLY_MIN_BLOCKS), bh);
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = APPLY_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, apply_chunks<VEC>, q, q_bstride, heads, n, apply_cols,
                           static_cast<const float*>(ctx), out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
constexpr int STAGE_FLOATS = WARPS * STAGES * 2 * SLICE;
constexpr int BWD_BLOCKS_PER_SM = 2;      // blocks an SM holds (shared memory, registers)
constexpr int BWD_MIN_BLOCKS = BWD_BLOCKS_PER_SM * 132;  // a block for each slot of the H100's 132 SMs

static_assert(WARPS * D * D <= STAGE_FLOATS, "the warps' dC' sums reuse the staged slices");
static_assert(W == 16 || W == 32, "a slice is one or two lanes a column");

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

}  // namespace

extern "C" {

// The forward's route for B*h = bh and N = n: la_cluster's cluster size, or 0 for the two
// launches (context_chunks, apply_chunks).
int la_forward_route(int bh, int n) { return forward_route(bh, n); }

// Floats of scratch that la_forward_f32 needs for B*h = bh and N = n: the chunks' partials of
// the two-launch route.
long long la_workspace_floats(int bh, int n) {
  return forward_route(bh, n) == 0 ? (long long)bh * fwd_chunks(bh, n, FWD_MIN_BLOCKS) * PART : 0;
}

// Launches the forward on `stream` by la_forward_route's route; returns the first CUDA error,
// else 0.
// Pointers are device pointers. Besides out (B, h, d, N) it writes ctx = scale*C (B*h*d*d
// floats, 16-byte aligned) and stats = (m, l) of softmax_N(k) (B*h*2*d floats), which the
// backward reads. The workspace holds la_workspace_floats(batch * heads, n); arrivals holds
// batch * heads counters that are 0, and are 0 again when the call ends.
int la_forward_f32(const float* q, const float* k, const float* v, float* out, float* ctx,
                   float* stats, float* workspace, unsigned* arrivals, long long q_bstride,
                   long long k_bstride, long long v_bstride, int batch, int heads, int n,
                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const bool vec = n % 4 == 0 && q_bstride % 4 == 0 && k_bstride % 4 == 0 && v_bstride % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  if (forward_route(bh, n) > 0)
    return (vec ? launch_cluster<true> : launch_cluster<false>)(
        q, k, v, out, ctx, stats, q_bstride, k_bstride, v_bstride, bh, heads, n, scale, s);
  return (vec ? launch_chunks<true> : launch_chunks<false>)(q, k, v, out, ctx, stats, workspace,
                                                            arrivals, q_bstride, k_bstride,
                                                            v_bstride, bh, heads, n, scale, s);
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
