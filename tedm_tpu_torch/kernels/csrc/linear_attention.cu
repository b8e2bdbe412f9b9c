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
// writes dq, dk, dv, 7*B*h*d*N*4 bytes, for about 10*B*h*d*d*N FLOPs. Both
// are about 8 FLOPs per byte, far under the card's fp32 ratio: at the
// training shape (16, 4, 32, 16384) the backward moves 940 MB, 0.28 ms at
// 3.35 TB/s, against 0.16 ms of fp32 arithmetic.
//
// Design. The TPU kernels hold one (b, h) row of N in VMEM and walk the grid
// in order. On the H100 one block per (b, h) would fill 32 of 132 SMs and a
// row does not fit in shared memory, so N is split across blocks and every
// direction is three launches on the caller's stream.
// Forward:
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
// Backward, from the forward's scale*C and (m, l):
//   1. grad_partials: grid (chunks of 512 columns, B*h). Stages tiles of q
//      and g, takes softmax_d of each q column in shared memory, and sums
//      dC' = s g^T over the chunk with the same 4x4 register blocks.
//   2. combine_grad: grid B*h. Sums the chunks into dC' and forms
//      r[d] = sum_e dC'[d,e] (scale C)[d,e], which is the softmax-N VJP's
//      sum over N without another pass over the columns.
//   3. apply_grad: grid (N / 256, B*h). One thread per column: s and
//      p = exp(k - m) / l in registers, then dq, dv and dk from three 32x32
//      matrix-vector products against scale*C and dC' in shared memory.
// The scratch is allocated by the caller (la_workspace_floats,
// la_backward_workspace_floats). No tensor cores: the contractions are 32
// deep and the kernels are bound by memory, not by arithmetic.
//
// q, k, v and g may each have any batch stride; within a batch element they
// must be contiguous (head stride d*N, row stride N). out, dq, dk and dv are
// contiguous.

#include <cuda_runtime.h>
#include <math.h>

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

__global__ void __launch_bounds__(CTX_THREADS)
grad_partials(const float* __restrict__ q, const float* __restrict__ g,
              long long q_bstride, long long g_bstride, int heads, int n,
              int n_chunks, float* __restrict__ partials) {
  __shared__ float ss[D][TILE + 1];
  __shared__ float gs[D][TILE + 1];

  const int bh = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  const float* qb = q + b * q_bstride + (long long)h * D * n;
  const float* gb = g + b * g_bstride + (long long)h * D * n;
  const Block4x4 blk(t);
  float acc[4][4] = {};

  const int start = chunk * CHUNK;
  const int end = min(start + CHUNK, n);
  for (int base = start; base < end; base += TILE) {
    __syncthreads();  // the previous tile is consumed
    const int c = t % TILE;
    const bool valid = base + c < end;
    for (int row = t / TILE; row < D; row += CTX_THREADS / TILE) {
      // a column past the end has g = 0 and adds nothing to dC'
      ss[row][c] = valid ? qb[(long long)row * n + base + c] : 0.f;
      gs[row][c] = valid ? gb[(long long)row * n + base + c] : 0.f;
    }
    __syncthreads();
    if (t < TILE) {  // softmax over d of column t, in shared memory
      float mx = -INFINITY;
      for (int d = 0; d < D; ++d) mx = fmaxf(mx, ss[d][t]);
      float sum = 0.f;
      for (int d = 0; d < D; ++d) {
        const float e = expf(ss[d][t] - mx);
        ss[d][t] = e;
        sum += e;
      }
      const float inv = 1.f / sum;
      for (int d = 0; d < D; ++d) ss[d][t] *= inv;
    }
    __syncthreads();
    accumulate_tile(acc, ss, gs, blk);
  }
  reduce_groups(acc, &ss[0][0], blk, partials + ((long long)bh * n_chunks + chunk) * D * D);
}

__global__ void __launch_bounds__(D * D)
combine_grad(const float* __restrict__ partials, int n_chunks, const float* __restrict__ ctx,
             float* __restrict__ dctx, float* __restrict__ r) {
  const int bh = blockIdx.x, t = threadIdx.x;
  const float* p = partials + (long long)bh * n_chunks * D * D;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[c * D * D + t];
  dctx[(long long)bh * D * D + t] = acc;
  // warp d holds row d of dC' and of scale*C
  const float rd = warp_sum(acc * ctx[(long long)bh * D * D + t]);
  if (t % 32 == 0) r[(long long)bh * D + t / D] = rd;
}

__global__ void __launch_bounds__(COLS)
apply_grad(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ g, long long q_bstride, long long k_bstride,
           long long v_bstride, long long g_bstride, int heads, int n,
           const float* __restrict__ ctx, const float* __restrict__ stats,
           const float* __restrict__ dctx, const float* __restrict__ r, float coef,
           float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv) {
  __shared__ float4 cs[D * D / 4];   // scale*C[d][e], e fastest
  __shared__ float4 dcs[D * D / 4];  // dC'[d][e], e fastest
  __shared__ float m_s[D], linv_s[D], r_s[D];
  const int bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  cs[t] = reinterpret_cast<const float4*>(ctx + (long long)bh * D * D)[t];
  dcs[t] = reinterpret_cast<const float4*>(dctx + (long long)bh * D * D)[t];
  if (t < D) {
    m_s[t] = stats[(long long)bh * 2 * D + t];
    linv_s[t] = 1.f / stats[(long long)bh * 2 * D + D + t];
    r_s[t] = r[(long long)bh * D + t];
  }
  __syncthreads();
  const int col = blockIdx.x * COLS + t;
  if (col >= n) return;
  const long long head = (long long)h * D * n + col;
  const long long out_at = (long long)bh * D * n + col;

  {  // dq = s * (ds - sum_d s*ds), ds = (scale C) g
    float s[D], gv[D], ds[D];
    load_column(s, q + b * q_bstride + head, n);
    softmax_d(s);
    load_column(gv, g + b * g_bstride + head, n);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = 0.f;
#pragma unroll
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 c = cs[d * (D / 4) + e4];
        a = fmaf(c.x, gv[4 * e4 + 0], a);
        a = fmaf(c.y, gv[4 * e4 + 1], a);
        a = fmaf(c.z, gv[4 * e4 + 2], a);
        a = fmaf(c.w, gv[4 * e4 + 3], a);
      }
      ds[d] = a;
      dot = fmaf(s[d], a, dot);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dq[out_at + (long long)d * n] = s[d] * (ds[d] - dot);
  }

  float p[D], vv[D];
  load_column(p, k + b * k_bstride + head, n);
#pragma unroll
  for (int d = 0; d < D; ++d) p[d] = expf(p[d] - m_s[d]) * linv_s[d];
  load_column(vv, v + b * v_bstride + head, n);
  // dv[e] = coef * sum_d dC'[d][e] p[d]
#pragma unroll
  for (int e4 = 0; e4 < D / 4; ++e4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float4 c = dcs[d * (D / 4) + e4];
      a.x = fmaf(c.x, p[d], a.x);
      a.y = fmaf(c.y, p[d], a.y);
      a.z = fmaf(c.z, p[d], a.z);
      a.w = fmaf(c.w, p[d], a.w);
    }
    dv[out_at + (long long)(4 * e4 + 0) * n] = a.x * coef;
    dv[out_at + (long long)(4 * e4 + 1) * n] = a.y * coef;
    dv[out_at + (long long)(4 * e4 + 2) * n] = a.z * coef;
    dv[out_at + (long long)(4 * e4 + 3) * n] = a.w * coef;
  }
  // dk[d] = p[d] * (coef * sum_e dC'[d][e] v[e] - r[d])
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = 0.f;
#pragma unroll
    for (int e4 = 0; e4 < D / 4; ++e4) {
      const float4 c = dcs[d * (D / 4) + e4];
      a = fmaf(c.x, vv[4 * e4 + 0], a);
      a = fmaf(c.y, vv[4 * e4 + 1], a);
      a = fmaf(c.z, vv[4 * e4 + 2], a);
      a = fmaf(c.w, vv[4 * e4 + 3], a);
    }
    dk[out_at + (long long)d * n] = p[d] * (a * coef - r_s[d]);
  }
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

// Floats of scratch that la_backward_f32 needs for B*h = bh and N = n.
long long la_backward_workspace_floats(int bh, int n) {
  return (long long)bh * chunks_of(n) * D * D + (long long)bh * D * D + (long long)bh * D;
}

// Launches the three backward passes on `stream`; returns as la_forward_f32.
// ctx and stats are the forward's outputs for the same q, k, v and scale; g
// is the gradient of out. Writes dq, dk, dv (B, h, d, N), contiguous.
int la_backward_f32(const float* q, const float* k, const float* v, const float* g,
                    const float* ctx, const float* stats, float* dq, float* dk, float* dv,
                    float* workspace, long long q_bstride, long long k_bstride,
                    long long v_bstride, long long g_bstride, int batch, int heads, int n,
                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, n_chunks = chunks_of(n);
  float* partials = workspace;
  float* dctx = partials + (long long)bh * n_chunks * D * D;  // 16-byte aligned
  float* r = dctx + (long long)bh * D * D;
  grad_partials<<<dim3(n_chunks, bh), CTX_THREADS, 0, s>>>(q, g, q_bstride, g_bstride, heads, n,
                                                            n_chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_grad<<<bh, D * D, 0, s>>>(partials, n_chunks, ctx, dctx, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_grad<<<dim3((n + COLS - 1) / COLS, bh), COLS, 0, s>>>(
      q, k, v, g, q_bstride, k_bstride, v_bstride, g_bstride, heads, n, ctx, stats, dctx, r,
      scale / (float)n, dq, dk, dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
