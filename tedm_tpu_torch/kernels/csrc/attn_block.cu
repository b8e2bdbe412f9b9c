// The fused Residual(PreNorm(LinearAttention)) block, bf16 on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tedm_tpu/ops/pallas/attn_block.py: _kernel, launched by
// _fwd_pallas behind prenorm_linear_attention. For one batch element, over x (C, N) bf16 (the
// (C, H*W) view of an NCHW activation), 4 heads of d = 32 (hidden = 128):
//
//     y    = bf16(ChanLN_in(x))                          fp32 statistics
//     k, v = W_k y, W_v y                                 bf16 products, fp32 sums, kept fp32
//     ctx  = per head: bf16(exp(k - max_N k)) bf16(v)^T / (sum_N exp(k - max_N k) * N)
//     q    = W_q y;  qs = softmax_d(q) * scale            per head, less the position's max
//     attn = per head: bf16(ctx)^T bf16(qs)
//     o    = W_out bf16(attn) + b_out;  out = bf16(ChanLN_out(o) + x)
//
// with every cast where the Pallas kernel casts (plain version: kernels/attn_block.py).
//
// What bounds it: on the 128^2 UNet both sides of the roofline about equally. At (B = 8,
// C = 64, N = 16384) it must read x and write out, 33.6 MB (10.0 us at 3.35 TB/s), and do
// 2*B*N*(4*128*C) + 4*B*128*32*N = 10.7 GFLOP of products (10.9 us at 989 TFLOP/s bf16).
// The JAX package's block moved more: its fp32 qkv slab alone is 25 MB per image at N = 16384.
//
// What held the first version of this kernel back, measured per launch on an H100 (chip_smoke.py
// phase 3; clock64 stamps per phase, scripts/port/attn_block_phases.py): neither the products nor
// device memory, but each block's serial chain. At (8, 64, 16384) its kv pass took 205 us, some
// 28 us a 64-column tile whose products take well under 1 us: a tile of x came in by one 2-byte
// load after another, each waited on; every block read W_qkv and W_out in fp32 through L2 (four
// 8-byte loads and four conversions a fragment); y was written transposed to shared memory; half
// the warps ran k's softmax while the others waited; a third launch combined the chunks; and at
// N = 256 and 1024 the grids left most of the 132 SMs idle.
//
// Design. An H100 block has 227 KB of shared memory, and k's softmax and the context run over
// all of N before any output column can be written, so N is split across blocks in two
// launches on the caller's stream. Both take N in tiles of T columns (T = 64, 32 or 16: the
// largest the channels' shared memory allows that still gives some 128 tiles) and bring x in
// by cp.async, 16 bytes a copy. The products are mma.sync m16n8k16 (bf16 in, fp32 sums) whose
// A fragments are the bf16 weights in fragment order (kernels/attn_block.py, fragment_layout:
// one 16-byte load a lane a fragment, a layout built once per weight version), read through L2
// a group of k-steps ahead of their products; their B operand, a tile in shared memory
// [channel][column], is read by transposed ldmatrix. A tile's LayerNorm statistics are column
// sums of 16-byte loads, summed over a warp's rows by shuffles and over the warps in shared
// memory, in a fixed order.
//   1. kv_context: grid (chunks, B), a chunk whole tiles, as few chunks as keep every SM at two
//      blocks (264), at most max_chunks a batch element. The next tile's x comes into the other
//      of two stages while this one is worked on, and where C <= 64 (the 128^2 and 64^2 stages,
//      most of the pass's time) W_k and W_v's fragments are staged in shared memory once a
//      block. y overwrites x in place. Warp w takes
//      k rows 16 w .. 16 w + 15 (half of head w / 2), then the v rows of the same indices, so
//      that all 8 warps share k's softmax: an online softmax keeps a running max m and sum l per
//      row in registers and rescales the context by exp(m_old - m_new); the four diagonal
//      32 x 32 head blocks of the context are accumulated in registers, warp w rows 16 w ..
//      The block writes (m, l, P) of its chunk, and the last block of a batch element to finish
//      (an atomic count of arrivals, zeroed before the launch) combines the chunks, issuing a
//      chunk's loads together: rescaled to the global max, summed, times 1 / (l * N), written
//      in bf16 in the A-fragment order of pass 2's per-head products.
//   2. apply_block: grid (N / T, B), a tile a block, launched as a programmatic dependent of pass
//      1 (its blocks start as pass 1's free their SMs and wait for pass 1 to complete only
//      before they read the context, so that the combines' tail overlaps the work before it):
//      its LayerNorm, q = W_q y, softmax_d per head
//      with the position's max over all 128 rows (per-warp partial maxima and sums in shared
//      memory), attn = ctx^T qs per head, o = W_out attn + b_out, the output LayerNorm's column
//      sums (per 16-row tile partials, summed in a fixed order) and the residual, staged in
//      shared memory for 16-byte stores. (Blocks that walk many tiles with x double-buffered and
//      the weights staged measured no faster on the H100: they held more registers, PERF.md.)
// The products stay on mma.sync, not wgmma: at these widths (K = C <= 512, M = 16 rows a warp,
// N = a tile) they take a small share of each block's time, and their operands are fragments
// that registers and ldmatrix give directly; what each tile waits on is its chain of phases,
// which the design shortens (16-byte copies ahead of use, fragment-order weights, balanced
// warps, fewer launches). Every sum runs in a fixed order: the output is the same from run to
// run. x may have any batch stride; within a batch element it is contiguous. out is contiguous.
// Where N is not a multiple of 8 or x's rows are not 16-byte aligned, x comes by plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HEADS = 4, DH = 32, HID = HEADS * DH;  // 4 heads of 32
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int STAGE_C = 64;                          // pass 1 stages W_k, W_v up to this C
constexpr int PART = 2 * HID + HID * DH;             // m[128], l[128], P[128][32] per chunk
constexpr int CTX = HEADS * DH * DH;                 // bf16 values of one image's context
constexpr int MIN_BLOCKS = 128;                      // a tile small enough to give this many
constexpr unsigned FULL = 0xffffffffu;

// bf16 row pitch of a tile of t columns: rows 16-byte aligned, ldmatrix conflict-free
__host__ __device__ constexpr int pitch(int t) { return t + 8; }

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Shared memory of the two passes, carved in this order by the kernels.
__host__ __device__ size_t context_smem(int t, int c) {
  return (c <= STAGE_C ? size_t(2 * HID) * c * 2 : 0)  // W_k, W_v's fragments, staged
         + 2 * align16(size_t(c) * pitch(t) * 2)      // xs  [2][c][t+8]  bf16: x, then y
         + 2 * align16(size_t(HID) * pitch(t) * 2)    // ks, vs [128][t+8] bf16
         + align16(size_t(2 * t + 2 * WARPS * t + HID + c) * 4);  // mean, rstd, red, fac, g_in
}

// Chunks of a batch element in pass 1, at most: the last block's table of (chunk, row) scales
// fills ks and vs
__host__ __device__ constexpr int max_chunks(int t) { return t + 8; }

__host__ __device__ size_t apply_smem(int t, int c) {
  return 2 * align16(size_t(c) * pitch(t) * 2)      // xs, ys [c][t+8] bf16; ys later out
         + 2 * align16(size_t(HID) * pitch(t) * 2)  // qs, at [128][t+8] bf16
         + align16(size_t(2 * t + 4 * WARPS * t + 2 * (c / 16) * t) * 4);
}  // mean, rstd, red [2][8][t], qmax, qsum [8][t], part [c/16][t][2]

struct Carve {
  unsigned char* p;
  template <typename E>
  __device__ E* take(size_t bytes) {
    E* r = reinterpret_cast<E*>(p);
    p += align16(bytes);
    return r;
  }
};

// e^x as 2^(x log2 e), for the softmaxes (x <= 0): relative error |x| 2^-24 from rounding x log2 e,
// plus exp2f's 2 ulp, so below 1e-6 where |x| <= 16 and the terms are not negligible; the fp32
// sums over N differ by as much with their order. It takes fewer instructions than expf, and
// the softmaxes are where the blocks' issue slots go (scripts/port/attn_block_phases.py)
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * 1.44269504088896341f); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b, one m16n8k16 tile: a from a fragment-order uint4, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  const uint32_t af[4] = {a.x, a.y, a.z, a.w};
  tc::mma_bf16(d, af, b0, b1);
}

// A fragment of a bf16 row-major matrix in shared memory (row stride lds, even)
__device__ __forceinline__ uint4 load_a_shared(const bf16* s, int lds, int row0, int k0, int lane) {
  const bf16* p = s + (row0 + (lane >> 2)) * lds + k0 + 2 * (lane & 3);
  return make_uint4(*reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + 8 * lds),
                    *reinterpret_cast<const uint32_t*>(p + 8), *reinterpret_cast<const uint32_t*>(p + 8 * lds + 8));
}

// B fragment (16 x 8 at k0, n0) of a (k x n) matrix stored n-major, k contiguous, in shared memory
__device__ __forceinline__ void load_b_shared(uint32_t& b0, uint32_t& b1, const bf16* s, int lds,
                                              int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * lds + k0 + 2 * (lane & 3);
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The bf16 index of element (row, col) of a 32 x 32 matrix in A-fragment order: 16 x 16 tiles
// (row tile, col tile), each [lane][a0..a3][2 values] (kernels/attn_block.py, fragment_layout)
__device__ __forceinline__ int frag_index32(int row, int col) {
  const int mt = row >> 4, r = (row >> 3) & 1, g = row & 7;
  const int kt = col >> 4, c8 = (col >> 3) & 1, t = (col >> 1) & 3;
  return (((mt * 2 + kt) * 32 + 4 * g + t) * 4 + 2 * c8 + r) * 2 + (col & 1);
}

// acc[mt][nt] += W[m-tile mt0 + mt][0 .. K) S[0 .. K)[n-tile nt]: W's A fragments in fragment
// order ([m-tile][k-tile][lane], kt k-tiles of 16) in global memory or a copy of them in shared
// memory (plain loads reach either), S a (K x 8 NT) bf16 tile in
// shared memory, row-major with pitch(T), read by transposed ldmatrix two n-tiles at a time. The
// A fragments of KB k-tiles are fetched one group ahead of the group being multiplied (4 / MT
// k-tiles a group: 32 registers a group, so that two blocks of 256 threads fit an SM).
template <int MT, int NT, int T>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], const uint4* wf, int kt,
                                     int mt0, const bf16* s, int lane) {
  constexpr int KB = 4 / MT;
  const uint32_t s_lane =
      tc::smem_addr(s) + 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch(T) + 8 * (lane >> 4));
  uint4 a0[KB][MT], a1[KB][MT];
  auto fetch = [&](uint4(&a)[KB][MT], int k0) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a[kb][mt] = k0 + kb < kt ? wf[((mt0 + mt) * kt + k0 + kb) * 32 + lane] : make_uint4(0u, 0u, 0u, 0u);
  };
  auto multiply = [&](const uint4(&a)[KB][MT], int k0) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (k0 + kb >= kt) break;
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, s_lane + 2 * ((k0 + kb) * 16 * pitch(T) + 8 * np));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][np], a[kb][mt], r[0], r[1]);
          mma(acc[mt][np + 1], a[kb][mt], r[2], r[3]);
        }
      }
    }
  };
  fetch(a0, 0);
  for (int k0 = 0; k0 < kt; k0 += 2 * KB) {
    if (k0 + KB < kt) fetch(a1, k0 + KB);
    multiply(a0, k0);
    if (k0 + KB >= kt) break;
    if (k0 + 2 * KB < kt) fetch(a0, k0 + 2 * KB);
    multiply(a1, k0 + KB);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_addr(dst)), "l"(src),
               "r"(inside ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Columns [n0, n0 + T) of the c rows of one image's x (row stride n) into s[c][pitch(T)], zeros
// past n: with vec (n a multiple of 8, rows 16-byte aligned) by cp.async, 16 bytes a copy, which
// the caller commits and waits for; else by plain loads.
template <int T>
__device__ void load_tile(bf16* s, const bf16* __restrict__ xb, int c, int n, int n0, bool vec) {
  constexpr int CH = T / 8;  // 16-byte copies a row
  if (vec) {
    for (int i = threadIdx.x; i < c * CH; i += THREADS) {
      const int row = i / CH, k = i % CH, col = n0 + 8 * k;
      const bool inside = col < n;
      cp_async16(s + row * pitch(T) + 8 * k, xb + (long long)row * n + (inside ? col : 0), inside);
    }
  } else {
    for (int i = threadIdx.x; i < c * T; i += THREADS) {
      const int row = i / T, col = i % T;
      s[row * pitch(T) + col] = n0 + col < n ? xb[(long long)row * n + n0 + col] : __float2bfloat16(0.f);
    }
  }
}

// mean and 1/sqrt(var + 1e-5) of each of the T columns of s[c][pitch(T)] over its c rows: fp32,
// one pass, var = E[s^2] - mean^2 clamped at 0. A thread sums 8 columns of every (THREADS / (T /
// 8))-th row from 16-byte loads; the rows of a warp by shuffles, the warps in shared memory, in a
// fixed order. red holds 2 * WARPS * T floats. Ends synchronised.
template <int T>
__device__ void column_stats(const bf16* s, int c, float* mean, float* rstd, float* red) {
  constexpr int G = T / 8, PARTS = THREADS / G;  // 16-byte column groups, row parts
  const int tid = threadIdx.x, k = tid % G, warp = tid >> 5;
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  for (int ch = tid / G; ch < c; ch += PARTS) {
    const uint4 v = *reinterpret_cast<const uint4*>(s + ch * pitch(T) + 8 * k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s1[j] += f;
      s2[j] = fmaf(f, f, s2[j]);
    }
  }
#pragma unroll
  for (int o = G; o < 32; o <<= 1)  // the lanes of one column group: k, k + G, ..
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] += __shfl_xor_sync(FULL, s1[j], o);
      s2[j] += __shfl_xor_sync(FULL, s2[j], o);
    }
  if ((tid & 31) < G)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp * T + 8 * k + j] = s1[j];
      red[(WARPS + warp) * T + 8 * k + j] = s2[j];
    }
  __syncthreads();
  if (tid < T) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += red[w * T + tid];
      b += red[(WARPS + w) * T + tid];
    }
    const float mu = a / (float)c;
    mean[tid] = mu;
    rstd[tid] = rsqrtf(fmaxf(b / (float)c - mu * mu, 0.f) + 1e-5f);
  }
  __syncthreads();
}

// dst = bf16((src - mean) * rstd * g) over a [c][pitch(T)] tile, 8 columns a step by 16-byte
// loads and stores; dst may be src. Ends synchronised.
template <int T>
__device__ void normalize(const bf16* src, bf16* dst, int c, const float* mean, const float* rstd,
                          const float* g) {
  constexpr int G = T / 8;
  for (int i = threadIdx.x; i < c * G; i += THREADS) {
    const int row = i / G, col = 8 * (i % G);
    const uint4 v = *reinterpret_cast<const uint4*>(src + row * pitch(T) + col);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const float gr = g[row];
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = col + 2 * j;
      op[j] = pack2((__bfloat162float(e[2 * j]) - mean[a]) * rstd[a] * gr,
                    (__bfloat162float(e[2 * j + 1]) - mean[a + 1]) * rstd[a + 1] * gr);
    }
    *reinterpret_cast<uint4*>(dst + row * pitch(T) + col) = o;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------- pass 1

template <int T>
__global__ void __launch_bounds__(THREADS, 2)
kv_context(const bf16* __restrict__ x, long long x_bstride, int c, int n, int chunk_cols, int n_chunks,
           int vec, const float* __restrict__ g_in, const uint4* __restrict__ wqkv,
           float* __restrict__ partials, unsigned* __restrict__ arrivals, bf16* __restrict__ ctx_out) {
  constexpr int NT = T / 8, KS = pitch(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  Carve cv{smem};
  const bool staged = c <= STAGE_C;
  uint4* wsm = staged ? cv.take<uint4>(size_t(2 * HID) * c * 2) : nullptr;
  bf16* xs[2];
  xs[0] = cv.take<bf16>(size_t(c) * KS * 2);
  xs[1] = cv.take<bf16>(size_t(c) * KS * 2);
  bf16* ks = cv.take<bf16>(size_t(HID) * KS * 2);
  bf16* vs = cv.take<bf16>(size_t(HID) * KS * 2);
  float* mean = cv.take<float>(0);
  float* rstd = mean + T;
  float* red = rstd + T;
  float* fac = red + 2 * WARPS * T;
  float* gin = fac + HID;  // g_in (c,)

  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int hh = warp >> 1, mh = warp & 1;  // this warp's half of a head's context
  const bf16* xb = x + b * x_bstride;

  // warp w: k rows 16 w + (g, g + 8) (head w / 2) and the v rows of the same indices
  float m_run[2], l_run[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float ctx[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) ctx[nt][j] = 0.f;

  const int begin = chunk * chunk_cols, end = min(begin + chunk_cols, n), kt = c / 16;
  // W_k and W_v's fragments (m-tiles 8 .. 23), from shared memory where staged
  const uint4* wkv = wqkv + 8 * kt * 32;
  if (staged) {
    for (int i = tid; i < 2 * HID * c / 8; i += THREADS) cp_async16(wsm + i, wkv + i, true);
    wkv = wsm;
  }
  for (int i = tid; i < c; i += THREADS) gin[i] = __ldg(g_in + i);
  load_tile<T>(xs[0], xb, c, n, begin, vec);
  cp_async_commit();
  int stage = 0;
  for (int n0 = begin; n0 < end; n0 += T, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; the previous tile's ks, vs, fac and other stage are consumed
    if (n0 + T < end) load_tile<T>(xs[stage ^ 1], xb, c, n, n0 + T, vec);
    cp_async_commit();
    bf16* ys = xs[stage];
    column_stats<T>(ys, c, mean, rstd, red);
    normalize<T>(ys, ys, c, mean, rstd, gin);

    // warp w: its 16 k rows (m-tile w of W_k, W_v's fragments), then its 16 v rows (m-tile 8 + w)
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      float acc[1][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][nt][j] = 0.f;
      gemm<1, NT, T>(acc, wkv, kt, 8 * kv + warp, ys, lane);
      if (kv == 0) {  // online softmax over N of the k rows; a column past n adds nothing
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (n0 + 8 * nt + 2 * t4 + j < n) mx = fmaxf(mx, acc[0][nt][2 * hf + j]);
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float m_new = fmaxf(m_run[hf], mx);  // finite: column n0 is inside
          const float f = exp_e(m_run[hf] - m_new);    // 0 on the first tile
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const bool inside = n0 + 8 * nt + 2 * t4 + j < n;
              const float e = inside ? exp_e(acc[0][nt][2 * hf + j] - m_new) : 0.f;
              acc[0][nt][2 * hf + j] = e;
              sum += e;
            }
          sum += __shfl_xor_sync(FULL, sum, 1);
          sum += __shfl_xor_sync(FULL, sum, 2);
          l_run[hf] = l_run[hf] * f + sum;  // the fp32 exponentials, before rounding
          m_run[hf] = m_new;
          if (t4 == 0) fac[16 * warp + 8 * hf + g] = f;
        }
      }
      // exp(k - m) or v, rounded to bf16, into ks or vs
      bf16* dst = (kv ? vs : ks) + 16 * warp * KS;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf16* p = dst + g * KS + 8 * nt + 2 * t4;
        *reinterpret_cast<uint32_t*>(p) = pack2(acc[0][nt][0], acc[0][nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * KS) = pack2(acc[0][nt][2], acc[0][nt][3]);
      }
    }
    __syncthreads();

    // context rows 16 mh .. 16 mh + 15 of head hh: rescale to the new max, add this tile
    const float f0 = fac[32 * hh + 16 * mh + g], f1 = fac[32 * hh + 16 * mh + g + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      ctx[nt][0] *= f0;
      ctx[nt][1] *= f0;
      ctx[nt][2] *= f1;
      ctx[nt][3] *= f1;
    }
#pragma unroll
    for (int k0 = 0; k0 < T; k0 += 16) {
      const uint4 a = load_a_shared(ks, KS, 32 * hh + 16 * mh, k0, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b_shared(b0, b1, vs, KS, 32 * hh + 8 * nt, k0, lane);
        mma(ctx[nt], a, b0, b1);
      }
    }
  }

  // pass 2 may launch once every block is here: its blocks start as SMs free up and wait for
  // this grid (griddepcontrol.wait) only before they read the context
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float* out = partials + ((long long)b * n_chunks + chunk) * PART;
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + 8 * r + g;
      out[row] = m_run[r];
      out[HID + row] = l_run[r];
    }
  }
  float* P = out + 2 * HID;
  {
    const int row = 32 * hh + 16 * mh + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 8 * nt + 2 * t4;
      P[row * DH + col] = ctx[nt][0];
      P[row * DH + col + 1] = ctx[nt][1];
      P[(row + 8) * DH + col] = ctx[nt][2];
      P[(row + 8) * DH + col + 1] = ctx[nt][3];
    }
  }

  // the last block of batch element b to get here combines its chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrivals[b], 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // per (chunk, row) the scale exp(m_chunk - m) to the global max, and per row the denominator;
  // then each thread sums 4 runs of 4 context values over the chunks, a chunk's 4 loads at once
  const float* pb = partials + (long long)b * n_chunks * PART;
  float* scale = reinterpret_cast<float*>(ks);  // [chunk][row]; ks and vs are free now
  float* denom = red;                            // [row] sum_chunks l exp(m_chunk - m) * N
  if (tid < HID) {
    float m = -INFINITY;
#pragma unroll 8
    for (int ch = 0; ch < n_chunks; ++ch) m = fmaxf(m, __ldcg(pb + (long long)ch * PART + tid));
    float l = 0.f;
#pragma unroll 8
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float f = exp_e(__ldcg(pb + (long long)ch * PART + tid) - m);
      scale[ch * HID + tid] = f;
      l = fmaf(__ldcg(pb + (long long)ch * PART + HID + tid), f, l);
    }
    denom[tid] = l * (float)n;
  }
  __syncthreads();
  constexpr int RUNS = HID * DH / 4 / THREADS;  // runs of 4 (row, e .. e + 3) a thread
  float4 acc[RUNS];
#pragma unroll
  for (int i = 0; i < RUNS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int ch = 0; ch < n_chunks; ++ch) {  // four chunks' loads in flight
    const float4* pc = reinterpret_cast<const float4*>(pb + (long long)ch * PART + 2 * HID);
    float4 v[RUNS];
#pragma unroll
    for (int i = 0; i < RUNS; ++i) v[i] = __ldcg(pc + tid + THREADS * i);
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const float f = scale[ch * HID + (tid + THREADS * i) / (DH / 4)];
      acc[i].x = fmaf(v[i].x, f, acc[i].x);
      acc[i].y = fmaf(v[i].y, f, acc[i].y);
      acc[i].z = fmaf(v[i].z, f, acc[i].z);
      acc[i].w = fmaf(v[i].w, f, acc[i].w);
    }
  }
  bf16* cb = ctx_out + (long long)b * CTX;
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int o = 4 * (tid + THREADS * i), row = o / DH, e = o % DH;  // row = 32 head + d
    const float vals[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k)  // ctx[h][d][e + k], as element (e + k, d) of head h's ctx^T
      cb[(row / DH) * DH * DH + frag_index32(e + k, row % DH)] = __float2bfloat16(vals[k] / denom[row]);
  }
}

// ---------------------------------------------------------------------------- pass 2

template <int T>
__global__ void __launch_bounds__(THREADS, 2)
apply_block(const bf16* __restrict__ x, long long x_bstride, int c, int n, int vec,
            const float* __restrict__ g_in, const uint4* __restrict__ wqkv,
            const uint4* ctx_frag, const uint4* __restrict__ wout,
            const float* __restrict__ b_out, const float* __restrict__ g_out, float scale,
            bf16* __restrict__ out) {
  constexpr int NT = T / 8, P = pitch(T);
  constexpr int NG = T < 32 ? T : 32, NGT = NG / 8;  // columns and n-tiles of an output item
  constexpr int IPW = 4;                             // output items a warp, at most (C = 512)
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  bf16* xs = cv.take<bf16>(size_t(c) * P * 2);
  bf16* ys = cv.take<bf16>(size_t(c) * P * 2);
  bf16* qs = cv.take<bf16>(size_t(HID) * P * 2);
  bf16* at = cv.take<bf16>(size_t(HID) * P * 2);
  float* mean = cv.take<float>(0);
  float* rstd = mean + T;
  float* red = rstd + T;
  float* qmax = red + 2 * WARPS * T;  // [8 warps][T]
  float* qsum = qmax + WARPS * T;     // [8 warps][T]
  float* part = qsum + WARPS * T;     // [c / 16][T][2]

  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  load_tile<T>(xs, x + b * x_bstride, c, n, n0, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  column_stats<T>(xs, c, mean, rstd, red);
  normalize<T>(xs, ys, c, mean, rstd, g_in);

  {  // q = W_q y: warp w rows 16 w .. 16 w + 15; softmax over d per head, less the max over all
     // 128 rows of the column; times scale, into qs
    float acc[1][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][nt][j] = 0.f;
    gemm<1, NT, T>(acc, wqkv, c / 16, warp, ys, lane);
    // lane holds rows g, g + 8 and columns 8 nt + 2 t4 + (0, 1)
    float cm[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaxf(acc[0][nt][e], acc[0][nt][2 + e]);
        for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
        cm[nt][e] = v;
      }
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) qmax[warp * T + 8 * nt + 2 * t4 + e] = cm[nt][e];
    __syncthreads();
    if (tid < T) {  // the column's max over the 8 warps' rows, into mean (free until o's norm)
      float mx = qmax[tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, qmax[w * T + tid]);
      mean[tid] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t4 + e;
        const float mx = mean[col];
        acc[0][nt][e] = exp_e(acc[0][nt][e] - mx);
        acc[0][nt][2 + e] = exp_e(acc[0][nt][2 + e] - mx);
        float sm = acc[0][nt][e] + acc[0][nt][2 + e];
        for (int o = 4; o < 32; o <<= 1) sm += __shfl_xor_sync(FULL, sm, o);
        cm[nt][e] = sm;
      }
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) qsum[warp * T + 8 * nt + 2 * t4 + e] = cm[nt][e];
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float q[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t4 + e;  // the head's sum: its two warps' partials
        const float sum = qsum[(warp & ~1) * T + col] + qsum[(warp | 1) * T + col];
        q[e] = acc[0][nt][e] / sum * scale;
        q[2 + e] = acc[0][nt][2 + e] / sum * scale;
      }
      bf16* p = qs + (16 * warp + g) * P + 8 * nt + 2 * t4;
      *reinterpret_cast<uint32_t*>(p) = pack2(q[0], q[1]);
      *reinterpret_cast<uint32_t*>(p + 8 * P) = pack2(q[2], q[3]);
    }
  }
  __syncthreads();

  // pass 1 (and its last blocks' combines) complete, its context visible. ctx_frag is not
  // __restrict__: loads through a restrict pointer to const may be hoisted above this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  {  // attn[h][e][n] = sum_d ctx[h][d][e] qs[h][d][n]: warp w takes head w / 2, rows 16 (w % 2) ..
    const int h = warp >> 1, mt = warp & 1;
    float acc[1][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][nt][j] = 0.f;
    gemm<1, NT, T>(acc, ctx_frag + (long long)b * (CTX / 8) + h * (DH * DH / 8), 2, mt, qs + 32 * h * P, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bf16* p = at + (32 * h + 16 * mt + g) * P + 8 * nt + 2 * t4;
      *reinterpret_cast<uint32_t*>(p) = pack2(acc[0][nt][0], acc[0][nt][1]);
      *reinterpret_cast<uint32_t*>(p + 8 * P) = pack2(acc[0][nt][2], acc[0][nt][3]);
    }
  }
  __syncthreads();

  // o = W_out attn + b_out, fp32, in items of 16 channels x NG columns, IPW at most a warp
  const int items = (c / 16) * (T / NG);
  float o[IPW][1][NGT][4];
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int it = warp + WARPS * i;
    if (it >= items) break;
    const int mt = it / (T / NG), ng = it % (T / NG);
#pragma unroll
    for (int nt = 0; nt < NGT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][0][nt][j] = 0.f;
    gemm<1, NGT, T>(o[i], wout, HID / 16, mt, at + NG * ng, lane);
    const int row = 16 * mt + g;
    const float bias0 = __ldg(b_out + row), bias1 = __ldg(b_out + row + 8);
    float s1[NGT][2], s2[NGT][2];
#pragma unroll
    for (int nt = 0; nt < NGT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = o[i][0][nt][e] + bias0, v1 = o[i][0][nt][2 + e] + bias1;
        o[i][0][nt][e] = v0;
        o[i][0][nt][2 + e] = v1;
        float a = v0 + v1, q = fmaf(v0, v0, v1 * v1);
        for (int sh = 4; sh < 32; sh <<= 1) {
          a += __shfl_xor_sync(FULL, a, sh);
          q += __shfl_xor_sync(FULL, q, sh);
        }
        s1[nt][e] = a;
        s2[nt][e] = q;
      }
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < NGT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* pp = part + 2 * (mt * T + NG * ng + 8 * nt + 2 * t4 + e);
          pp[0] = s1[nt][e];
          pp[1] = s2[nt][e];
        }
  }
  __syncthreads();
  if (tid < T) {  // the output LayerNorm's statistics, the 16-row partials summed in order
    float a = 0.f, q = 0.f;
    for (int mt = 0; mt < c / 16; ++mt) {
      a += part[2 * (mt * T + tid)];
      q += part[2 * (mt * T + tid) + 1];
    }
    const float mu = a / (float)c;
    mean[tid] = mu;
    rstd[tid] = rsqrtf(fmaxf(q / (float)c - mu * mu, 0.f) + 1e-5f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < IPW; ++i) {  // out = bf16(LN(o) + x), staged in ys
    const int it = warp + WARPS * i;
    if (it >= items) break;
    const int mt = it / (T / NG), ng = it % (T / NG), row = 16 * mt + g;
    const float gr0 = __ldg(g_out + row), gr1 = __ldg(g_out + row + 8);
#pragma unroll
    for (int nt = 0; nt < NGT; ++nt) {
      const int col = NG * ng + 8 * nt + 2 * t4;
      const __nv_bfloat162 x0 = *reinterpret_cast<const __nv_bfloat162*>(xs + row * P + col);
      const __nv_bfloat162 x1 = *reinterpret_cast<const __nv_bfloat162*>(xs + (row + 8) * P + col);
      *reinterpret_cast<uint32_t*>(ys + row * P + col) =
          pack2((o[i][0][nt][0] - mean[col]) * rstd[col] * gr0 + __low2float(x0),
                (o[i][0][nt][1] - mean[col + 1]) * rstd[col + 1] * gr0 + __high2float(x0));
      *reinterpret_cast<uint32_t*>(ys + (row + 8) * P + col) =
          pack2((o[i][0][nt][2] - mean[col]) * rstd[col] * gr1 + __low2float(x1),
                (o[i][0][nt][3] - mean[col + 1]) * rstd[col + 1] * gr1 + __high2float(x1));
    }
  }
  __syncthreads();
  bf16* ob = out + (long long)b * c * n;
  if (vec) {
    constexpr int CH = T / 8;
    for (int i = tid; i < c * CH; i += THREADS) {
      const int row = i / CH, col = 8 * (i % CH);
      if (n0 + col < n)
        *reinterpret_cast<uint4*>(ob + (long long)row * n + n0 + col) =
            *reinterpret_cast<const uint4*>(ys + row * P + col);
    }
  } else {
    for (int i = tid; i < c * T; i += THREADS) {
      const int row = i / T, col = i % T;
      if (n0 + col < n) ob[(long long)row * n + n0 + col] = ys[row * P + col];
    }
  }
}

int tile_max(int c) { return c <= 128 ? 64 : 32; }  // shared memory: 2-3 blocks an SM

// The largest tile the channels allow that leaves at least MIN_BLOCKS tiles in all (or 16)
int tile_of(int batch, int c, int n) {
  int t = tile_max(c);
  while (t > 16 && (long long)((n + t - 1) / t) * batch < MIN_BLOCKS) t /= 2;
  return t;
}

// Columns per block of pass 1: whole tiles, as few as leave no SM with more than two blocks
// (264 for the 132 SMs), and at most max_chunks chunks a batch element
int chunk_cols(int batch, int c, int n) {
  const int t = tile_of(batch, c, n), tiles = (n + t - 1) / t;
  const int per = (tiles * batch + 263) / 264, fewest = (tiles + max_chunks(t) - 1) / max_chunks(t);
  return t * (per > fewest ? per : fewest);
}

int chunks_of(int batch, int c, int n) {
  const int cols = chunk_cols(batch, c, n);
  return (n + cols - 1) / cols;
}

template <int T>
int launch(const bf16* x, const float* g_in, const uint4* wqkv, const uint4* wout, const float* b_out,
           const float* g_out, bf16* out, float* workspace, long long x_bstride, int batch, int c,
           int n, float scale, cudaStream_t s) {
  const int cols = chunk_cols(batch, c, n), n_chunks = chunks_of(batch, c, n);
  bf16* ctx = reinterpret_cast<bf16*>(workspace);  // [B][CTX] in A-fragment order
  float* partials = workspace + (long long)batch * CTX / 2;
  unsigned* arrivals = reinterpret_cast<unsigned*>(partials + (long long)batch * n_chunks * PART);
  const int vec = n % 8 == 0 && x_bstride % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t s1 = context_smem(T, c), s2 = apply_smem(T, c);
  cudaError_t err = cudaFuncSetAttribute(kv_context<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(apply_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(arrivals, 0, sizeof(unsigned) * batch, s);
  if (err != cudaSuccess) return (int)err;
  kv_context<T><<<dim3(n_chunks, batch), THREADS, s1, s>>>(x, x_bstride, c, n, cols, n_chunks, vec, g_in,
                                                           wqkv, partials, arrivals, ctx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a programmatic dependent launch: pass 2's blocks may start before pass 1 ends (Hopper)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + T - 1) / T, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = s2;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, apply_block<T>, x, x_bstride, c, n, vec, g_in, wqkv,
                           reinterpret_cast<const uint4*>(ctx), wout, b_out, g_out, scale, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that pla_forward_bf16 needs for `batch` images of c channels and n columns:
// the contexts, the chunks' partials and the arrival counts.
long long pla_workspace_floats(int batch, int c, int n) {
  return (long long)batch * CTX / 2 + (long long)batch * chunks_of(batch, c, n) * PART + batch;
}

// Launches the two passes on `stream`; returns the first CUDA error, else 0. Pointers are device
// pointers: x (B, c, n) bf16 with batch stride x_bstride, contiguous within an image; g_in, b_out,
// g_out (c,) fp32; w_qkv (3*128, c) and w_out (c, 128) bf16 in A-fragment order
// (kernels/attn_block.py, fragment_layout); out (B, c, n) bf16 contiguous; the workspace (16-byte
// aligned) holds pla_workspace_floats(batch, c, n). c is a multiple of 16 up to 512.
int pla_forward_bf16(const void* x, const float* g_in, const void* w_qkv, const void* w_out,
                     const float* b_out, const float* g_out, void* out, float* workspace,
                     long long x_bstride, int batch, int c, int n, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint4* wq = static_cast<const uint4*>(w_qkv);
  const uint4* wo = static_cast<const uint4*>(w_out);
  bf16* ob = static_cast<bf16*>(out);
  switch (tile_of(batch, c, n)) {
    case 64:
      return launch<64>(xb, g_in, wq, wo, b_out, g_out, ob, workspace, x_bstride, batch, c, n, scale, s);
    case 32:
      return launch<32>(xb, g_in, wq, wo, b_out, g_out, ob, workspace, x_bstride, batch, c, n, scale, s);
    default:
      return launch<16>(xb, g_in, wq, wo, b_out, g_out, ob, workspace, x_bstride, batch, c, n, scale, s);
  }
}

}  // extern "C"
