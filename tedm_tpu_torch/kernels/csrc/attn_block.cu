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
// Design. The TPU kernel holds one image's whole (N, 3*128) fp32 slab in VMEM (75 MB at
// N = 16384). An H100 block has 227 KB of shared memory, and k's softmax and the context run
// over all of N before any output column can be written, so N is split across blocks in three
// launches on the caller's stream:
//   1. kv_partials: grid (chunks, B), chunks of up to 512 columns, fewer where that fills the
//      SMs. A block walks its chunk in tiles of T columns (64, or 32 when C > 128): stages x,
//      takes each column's LayerNorm statistics, writes y transposed (channels contiguous)
//      for the tensor cores, and computes the (256 x T) k and v rows with mma.sync m16n8k16
//      (bf16 in, fp32 sums; W read from global memory, through L2, in fp32 and rounded into
//      the A fragments, four k-steps ahead of their products). Each warp owns 32 rows, so the
//      row max of k over the tile is a reduction inside the warp: an online softmax keeps a
//      running max m and sum l per row in registers and rescales the context by
//      exp(m_old - m_new). The four diagonal 32 x 32 head blocks of the context (the TPU takes
//      one masked 128 x 128 product, 3/4 of it wasted) are accumulated by 8 warps, one 16-row
//      half of a head each, in registers across the tiles. Writes (m, l, P) per chunk.
//   2. combine: grid B*4. Rescales the chunks to the global max, sums them, folds in
//      1 / (l * N), and writes the context in bf16, transposed for pass 3.
//   3. apply_block: grid (N / T, B). Recomputes the tile's LayerNorm and only its q rows
//      (one more read of x, in place of 25 MB of qkv per image), takes softmax_d per head in
//      shared memory, then attn = qs ctx (per head, on the tensor cores), o = W_out attn + b_out
//      (tensor cores, fp32 into shared memory), the output LayerNorm and the residual.
// The channel LayerNorms reduce over C, the strided axis of x: a tile is staged with N
// contiguous (coalesced reads), and the statistics are column sums in shared memory. x may
// have any batch stride; within a batch element it is contiguous. out is contiguous. No
// wgmma or TMA yet: mma.sync reads its operands from registers filled from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HEADS = 4, DH = 32, HID = HEADS * DH;  // 4 heads of 32
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 512;                        // columns per block of pass 1, at most
constexpr int PART = 2 * HID + HID * DH;              // m[128], l[128], P[128][32] per chunk
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Shared memory of pass 1 and pass 3, carved in this order by the kernels.
__host__ __device__ size_t partials_smem(int t, int c) {
  return align16(size_t(c) * (t + 2) * 2)          // xs  [c][t+2]   bf16
         + align16(size_t(t) * (c + 8) * 2)        // ys  [t][c+8]   bf16
         + 2 * align16(size_t(HID) * (t + 8) * 2)  // ks, vs [128][t+8] bf16
         + align16(size_t(2 * t + 2 * THREADS + HID) * 4);  // mean, rstd, red, fac
}

__host__ __device__ size_t output_bytes(int t, int c) {  // ys, later o [c][t+4] fp32
  const size_t ys = size_t(t) * (c + 8) * 2, os = size_t(c) * (t + 4) * 4;
  return align16(ys > os ? ys : os);
}

__host__ __device__ size_t apply_smem(int t, int c) {
  return align16(size_t(c) * (t + 2) * 2)          // xs  [c][t+2]      bf16
         + output_bytes(t, c)                      // ys / os
         + align16(size_t(HID) * (t + 4) * 4)      // qf  [128][t+4]    fp32
         + 2 * align16(size_t(t) * (HID + 8) * 2)  // qb, ab [t][128+8] bf16
         + align16(size_t(HID) * (DH + 8) * 2)     // cs  [128][32+8]   bf16
         + align16(size_t(2 * t + 2 * THREADS + HEADS * t) * 4);  // mean, rstd, red, hmax
}

struct Carve {
  unsigned char* p;
  template <typename E>
  __device__ E* take(size_t bytes) {
    E* r = reinterpret_cast<E*>(p);
    p += align16(bytes);
    return r;
  }
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

// d += a b, one m16n8k16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16 at row0, k0) of an fp32 row-major matrix in global memory, rounded to bf16
__device__ __forceinline__ void load_a_global(uint32_t (&a)[4], const float* __restrict__ w, int lda,
                                              int row0, int k0, int lane) {
  const float* p = w + (long long)(row0 + (lane >> 2)) * lda + k0 + 2 * (lane & 3);
  const float2 v0 = __ldg(reinterpret_cast<const float2*>(p));
  const float2 v1 = __ldg(reinterpret_cast<const float2*>(p + 8 * lda));
  const float2 v2 = __ldg(reinterpret_cast<const float2*>(p + 8));
  const float2 v3 = __ldg(reinterpret_cast<const float2*>(p + 8 * lda + 8));
  a[0] = pack2(v0.x, v0.y);
  a[1] = pack2(v1.x, v1.y);
  a[2] = pack2(v2.x, v2.y);
  a[3] = pack2(v3.x, v3.y);
}

// A fragment of a bf16 row-major matrix in shared memory (row stride lds, even)
__device__ __forceinline__ void load_a_shared(uint32_t (&a)[4], const bf16* s, int lds, int row0,
                                              int k0, int lane) {
  const bf16* p = s + (row0 + (lane >> 2)) * lds + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lds);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lds + 8);
}

// B fragment (16 x 8 at k0, n0) of a (k x n) matrix stored n-major, k contiguous, in shared memory
__device__ __forceinline__ void load_b_shared(uint32_t& b0, uint32_t& b1, const bf16* s, int lds,
                                              int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * lds + k0 + 2 * (lane & 3);
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// acc[mt][nt] += W[row0 + 16 mt .., 0 .. kdim) S[n0 + 8 nt .., 0 .. kdim)^T: W fp32 in global
// memory (row stride lda), S bf16 in shared memory, n-major (row stride lds). The A fragments of
// KB steps of 16 are loaded before their products, so KB global loads are in flight at once.
template <int MT, int NT>
__device__ __forceinline__ void gemm(float (&acc)[MT][NT][4], const float* __restrict__ w, int lda,
                                     int kdim, int row0, const bf16* s, int lds, int n0, int lane) {
  constexpr int KB = 4;
  for (int k0 = 0; k0 < kdim; k0 += 16 * KB) {
    uint32_t a[KB][MT][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      if (k0 + 16 * kb < kdim)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a_global(a[kb][mt], w, lda, row0 + 16 * mt, k0 + 16 * kb, lane);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (k0 + 16 * kb >= kdim) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b_shared(b0, b1, s, lds, n0 + 8 * nt, k0 + 16 * kb, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], a[kb][mt], b0, b1);
      }
    }
  }
}

// mean and 1/sqrt(var + 1e-5) of each of the T columns of s[c][ld] over its c rows: fp32,
// one pass, var = E[s^2] - mean^2 clamped at 0. red holds 2*THREADS floats. Ends synchronised.
template <int T, typename E>
__device__ void column_stats(const E* s, int ld, int c, float* mean, float* rstd, float* red) {
  constexpr int PARTS = THREADS / T;
  const int tid = threadIdx.x, col = tid % T, part = tid / T;
  float s1 = 0.f, s2 = 0.f;
  for (int ch = part; ch < c; ch += PARTS) {
    const float v = as_float(s[ch * ld + col]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  red[part * T + col] = s1;
  red[THREADS + part * T + col] = s2;
  __syncthreads();
  if (tid < T) {
    float a = 0.f, b = 0.f;
    for (int p = 0; p < PARTS; ++p) {
      a += red[p * T + tid];
      b += red[THREADS + p * T + tid];
    }
    const float mu = a / (float)c;
    mean[tid] = mu;
    rstd[tid] = rsqrtf(fmaxf(b / (float)c - mu * mu, 0.f) + 1e-5f);
  }
  __syncthreads();
}

// Stages columns [n0, n0 + T) of one image's x (c rows of n) into xs[c][T+2] (zeros past n),
// and writes y = bf16((x - mean) * rstd * g) into ys[T][c+8], channels contiguous. A column
// past n has y = 0. Ends synchronised.
template <int T>
__device__ void load_normalize(const bf16* __restrict__ xb, int n, int n0, int c,
                               const float* __restrict__ g, bf16* xs, bf16* ys, float* mean,
                               float* rstd, float* red) {
  constexpr int XS = T + 2;
  const int tid = threadIdx.x, ys_ld = c + 8;
  for (int i = tid; i < c * T; i += THREADS) {
    const int ch = i / T, col = i % T;
    xs[ch * XS + col] = n0 + col < n ? xb[(long long)ch * n + n0 + col] : __float2bfloat16(0.f);
  }
  __syncthreads();
  column_stats<T>(xs, XS, c, mean, rstd, red);
  for (int i = tid; i < c * T; i += THREADS) {
    const int col = i / c, ch = i % c;
    const float v = (__bfloat162float(xs[ch * XS + col]) - mean[col]) * rstd[col] * __ldg(g + ch);
    ys[col * ys_ld + ch] = __float2bfloat16(v);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------- pass 1

template <int T>
__global__ void __launch_bounds__(THREADS)
kv_partials(const bf16* __restrict__ x, long long x_bstride, int c, int n, int chunk_cols, int n_chunks,
            const float* __restrict__ g_in, const float* __restrict__ w_qkv,
            float* __restrict__ partials) {
  constexpr int NT = T / 8, KS = T + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  bf16* xs = cv.take<bf16>(size_t(c) * (T + 2) * 2);
  bf16* ys = cv.take<bf16>(size_t(T) * (c + 8) * 2);
  bf16* ks = cv.take<bf16>(size_t(HID) * KS * 2);
  bf16* vs = cv.take<bf16>(size_t(HID) * KS * 2);
  float* mean = cv.take<float>(0);
  float* rstd = mean + T;
  float* red = rstd + T;
  float* fac = red + 2 * THREADS;

  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int hh = warp >> 1, mh = warp & 1;  // this warp's half of a head's context
  const bf16* xb = x + b * x_bstride;

  // warps 0-3: the k rows of head `warp`, rows 32 warp + (g, g+8, 16+g, 24+g); 4-7: v rows
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float ctx[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) ctx[nt][j] = 0.f;

  const int end = min((chunk + 1) * chunk_cols, n);
  for (int n0 = chunk * chunk_cols; n0 < end; n0 += T) {
    __syncthreads();  // the previous tile's ks, vs and fac are consumed
    load_normalize<T>(xb, n, n0, c, g_in, xs, ys, mean, rstd, red);

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    gemm<2, NT>(acc, w_qkv, c, c, HID + 32 * warp, ys, c + 8, 0, lane);

    if (warp < HEADS) {  // online softmax over N of the k rows; a column past n adds nothing
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int mt = r >> 1, hf = r & 1;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n0 + 8 * nt + 2 * t4 + j < n) mx = fmaxf(mx, acc[mt][nt][2 * hf + j]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);  // finite: column n0 is inside
        const float f = expf(m_run[r] - m_new);    // 0 on the first tile
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bool inside = n0 + 8 * nt + 2 * t4 + j < n;
            const float e = inside ? expf(acc[mt][nt][2 * hf + j] - m_new) : 0.f;
            acc[mt][nt][2 * hf + j] = e;
            s += e;
          }
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        l_run[r] = l_run[r] * f + s;  // the fp32 exponentials, before rounding
        m_run[r] = m_new;
        if (t4 == 0) fac[32 * warp + 16 * mt + 8 * hf + g] = f;
      }
    }
    // exp(k - m) (warps 0-3) or v (warps 4-7), rounded to bf16, into ks or vs
    bf16* dst = (warp < HEADS ? ks : vs) + 32 * (warp % HEADS) * KS;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf16* p = dst + (16 * mt + g) * KS + 8 * nt + 2 * t4;
        *reinterpret_cast<uint32_t*>(p) = pack2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * KS) = pack2(acc[mt][nt][2], acc[mt][nt][3]);
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
      uint32_t a[4];
      load_a_shared(a, ks, KS, 32 * hh + 16 * mh, k0, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b_shared(b0, b1, vs, KS, 32 * hh + 8 * nt, k0, lane);
        mma(ctx[nt], a, b0, b1);
      }
    }
  }

  float* out = partials + ((long long)b * n_chunks + chunk) * PART;
  if (warp < HEADS && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 32 * warp + 16 * (r >> 1) + 8 * (r & 1) + g;
      out[row] = m_run[r];
      out[HID + row] = l_run[r];
    }
  }
  float* P = out + 2 * HID;
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

// ---------------------------------------------------------------------------- pass 2

__global__ void __launch_bounds__(DH * DH)
combine(const float* __restrict__ partials, int n_chunks, int n, bf16* __restrict__ ctx_t) {
  const int bh = blockIdx.x, b = bh / HEADS, h = bh % HEADS, t = threadIdx.x;
  const int d = t / DH, e = t % DH, row = h * DH + d;
  const float* p = partials + (long long)b * n_chunks * PART;
  float m = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, p[(long long)c * PART + row]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float* pc = p + (long long)c * PART;
    const float f = expf(pc[row] - m);
    l = fmaf(pc[HID + row], f, l);
    acc = fmaf(pc[2 * HID + row * DH + e], f, acc);
  }
  // ctx[h][d][e] stored as ctx_t[b][h][e][d]: pass 3 reads it as a B operand
  ctx_t[((long long)bh * DH + e) * DH + d] = __float2bfloat16(acc / (l * (float)n));
}

// ---------------------------------------------------------------------------- pass 3

template <int T>
__global__ void __launch_bounds__(THREADS)
apply_block(const bf16* __restrict__ x, long long x_bstride, int c, int n,
            const float* __restrict__ g_in, const float* __restrict__ w_qkv,
            const bf16* __restrict__ ctx_t, const float* __restrict__ w_out,
            const float* __restrict__ b_out, const float* __restrict__ g_out, float scale,
            bf16* __restrict__ out) {
  constexpr int NT = T / 8, XS = T + 2, QS = T + 4, OS = T + 4, QB = HID + 8, CS = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  Carve cv{smem};
  bf16* xs = cv.take<bf16>(size_t(c) * XS * 2);
  unsigned char* region = cv.take<unsigned char>(output_bytes(T, c));
  bf16* ys = reinterpret_cast<bf16*>(region);
  float* os = reinterpret_cast<float*>(region);  // o, once ys is read
  float* qf = cv.take<float>(size_t(HID) * QS * 4);
  bf16* qb = cv.take<bf16>(size_t(T) * QB * 2);
  bf16* ab = cv.take<bf16>(size_t(T) * QB * 2);
  bf16* cs = cv.take<bf16>(size_t(HID) * CS * 2);
  float* mean = cv.take<float>(0);
  float* rstd = mean + T;
  float* red = rstd + T;
  float* hmax = red + 2 * THREADS;

  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;

  // this image's context, rows (head, e), d contiguous
  const uint32_t* cb = reinterpret_cast<const uint32_t*>(ctx_t + (long long)b * HID * DH);
  for (int i = tid; i < HID * DH / 2; i += THREADS)
    *reinterpret_cast<uint32_t*>(cs + (i / (DH / 2)) * CS + 2 * (i % (DH / 2))) = cb[i];
  load_normalize<T>(x + b * x_bstride, n, n0, c, g_in, xs, ys, mean, rstd, red);

  {  // q = W_q y, rows 16 warp .. 16 warp + 15, fp32 into qf
    float acc[1][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][nt][j] = 0.f;
    gemm<1, NT>(acc, w_qkv, c, c, 16 * warp, ys, c + 8, 0, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = qf + (16 * warp + g) * QS + 8 * nt + 2 * t4;
      p[0] = acc[0][nt][0];
      p[1] = acc[0][nt][1];
      p[8 * QS] = acc[0][nt][2];
      p[8 * QS + 1] = acc[0][nt][3];
    }
  }
  __syncthreads();

  // softmax over d per head, less the max over all 128 rows of the column; times scale
  for (int p = tid; p < HEADS * T; p += THREADS) {
    const int col = p % T, h = p / T;
    float mx = -INFINITY;
    for (int d = 0; d < DH; ++d) mx = fmaxf(mx, qf[(h * DH + d) * QS + col]);
    hmax[h * T + col] = mx;
  }
  __syncthreads();
  for (int p = tid; p < HEADS * T; p += THREADS) {
    const int col = p % T, h = p / T;
    float mx = hmax[col];
#pragma unroll
    for (int hh = 1; hh < HEADS; ++hh) mx = fmaxf(mx, hmax[hh * T + col]);
    float e[DH], sum = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      e[d] = expf(qf[(h * DH + d) * QS + col] - mx);
      sum += e[d];
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) qb[col * QB + h * DH + d] = __float2bfloat16(e[d] / sum * scale);
  }
  __syncthreads();

  {  // attn[n][h, e] = sum_d qs[n][h, d] ctx[h][d][e]: warp w takes head w/2, T/2 columns
    constexpr int MT = T / 32;
    const int h = warp >> 1, nb = (warp & 1) * (T / 2);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < DH; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a_shared(a[mt], qb, QB, nb + 16 * mt, h * DH + k0, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b_shared(b0, b1, cs, CS, h * DH + 8 * nt, k0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bf16* p = ab + (nb + 16 * mt + g) * QB + h * DH + 8 * nt + 2 * t4;
        *reinterpret_cast<uint32_t*>(p) = pack2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * QB) = pack2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  __syncthreads();

  // o = W_out attn + b_out, fp32, in items of 16 channels x 32 columns
  const int items = (c / 16) * (T / 32);
  for (int it = warp; it < items; it += WARPS) {
    const int mt = it / (T / 32), ng = it % (T / 32);
    float acc[1][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][nt][j] = 0.f;
    gemm<1, 4>(acc, w_out, HID, HID, 16 * mt, ab, QB, 32 * ng, lane);
    const int row = 16 * mt + g;
    const float bias0 = __ldg(b_out + row), bias1 = __ldg(b_out + row + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = os + row * OS + 32 * ng + 8 * nt + 2 * t4;
      p[0] = acc[0][nt][0] + bias0;
      p[1] = acc[0][nt][1] + bias0;
      p[8 * OS] = acc[0][nt][2] + bias1;
      p[8 * OS + 1] = acc[0][nt][3] + bias1;
    }
  }
  __syncthreads();

  column_stats<T>(os, OS, c, mean, rstd, red);
  bf16* ob = out + (long long)b * c * n;
  for (int i = tid; i < c * T; i += THREADS) {
    const int ch = i / T, col = i % T;
    if (n0 + col < n) {
      const float o = (os[ch * OS + col] - mean[col]) * rstd[col] * __ldg(g_out + ch);
      ob[(long long)ch * n + n0 + col] = __float2bfloat16(o + __bfloat162float(xs[ch * XS + col]));
    }
  }
}

int tile_of(int c) { return c <= 128 ? 64 : 32; }

// Columns per block of pass 1: whole tiles, up to MAX_CHUNK, few enough that the grid covers
// the 132 SMs twice where N allows it
int chunk_cols(int batch, int c, int n) {
  const int t = tile_of(c), tiles = (n + t - 1) / t;
  const int per = tiles * batch / 264;
  return t * (per < 1 ? 1 : per > MAX_CHUNK / t ? MAX_CHUNK / t : per);
}

int chunks_of(int batch, int c, int n) {
  const int cols = chunk_cols(batch, c, n);
  return (n + cols - 1) / cols;
}

template <int T>
int launch(const bf16* x, const float* g_in, const float* w_qkv, const float* w_out,
           const float* b_out, const float* g_out, bf16* out, float* workspace,
           long long x_bstride, int batch, int c, int n, float scale, cudaStream_t s) {
  const int cols = chunk_cols(batch, c, n), n_chunks = chunks_of(batch, c, n);
  float* partials = workspace;
  bf16* ctx_t = reinterpret_cast<bf16*>(partials + (long long)batch * n_chunks * PART);
  const size_t s1 = partials_smem(T, c), s3 = apply_smem(T, c);
  cudaError_t err = cudaFuncSetAttribute(kv_partials<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(apply_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return (int)err;
  kv_partials<T><<<dim3(n_chunks, batch), THREADS, s1, s>>>(x, x_bstride, c, n, cols, n_chunks, g_in,
                                                            w_qkv, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine<<<batch * HEADS, DH * DH, 0, s>>>(partials, n_chunks, n, ctx_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_block<T><<<dim3((n + T - 1) / T, batch), THREADS, s3, s>>>(
      x, x_bstride, c, n, g_in, w_qkv, ctx_t, w_out, b_out, g_out, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that pla_forward_bf16 needs for `batch` images of c channels and n columns.
long long pla_workspace_floats(int batch, int c, int n) {
  return (long long)batch * chunks_of(batch, c, n) * PART + (long long)batch * HID * DH / 2;
}

// Launches the three passes on `stream`; returns the first CUDA error, else 0. Pointers are
// device pointers: x (B, c, n) bf16 with batch stride x_bstride, contiguous within an image;
// g_in, b_out, g_out (c,), w_qkv (3*128, c) and w_out (c, 128), all fp32 and contiguous; out
// (B, c, n) bf16 contiguous; the workspace holds pla_workspace_floats(batch, n). c is a
// multiple of 16 up to 512.
int pla_forward_bf16(const void* x, const float* g_in, const float* w_qkv, const float* w_out,
                     const float* b_out, const float* g_out, void* out, float* workspace,
                     long long x_bstride, int batch, int c, int n, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (tile_of(c) == 64)
    return launch<64>(xb, g_in, w_qkv, w_out, b_out, g_out, ob, workspace, x_bstride, batch, c, n,
                      scale, s);
  return launch<32>(xb, g_in, w_qkv, w_out, b_out, g_out, ob, workspace, x_bstride, batch, c, n,
                    scale, s);
}

}  // extern "C"
