// Linear attention forward, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tedm_tpu/ops/pallas/linear_attention.py
// (_fwd_kernel, launched by _fwd_pallas under linear_attention). For each
// (batch, head) pair, over q, k, v of shape (d = 32, N):
//
//     s   = softmax_d(q) * scale
//     p   = softmax_N(k)
//     C   = p (v / N)^T            (d x d context)
//     out = C^T s                  (d x N)
//
// What bounds it: memory. It must read q, k, v and write out, 4*B*h*d*N*4
// bytes, for 2*B*h*d*d*N*2 FLOPs, about 8 FLOPs per byte; at the 128x128
// stage (B=8, h=4, N=16384) that is 268 MB, about 80 us at 3.35 TB/s.
//
// Design. The TPU kernel holds one (b, h) row of N in VMEM and walks the
// grid in order. On the H100 one block per (b, h) would fill 32 of 132 SMs,
// so N is split across blocks, in three launches on the caller's stream:
//   1. context_partials: grid (chunks of 512 columns, B*h). A block stages
//      128-column tiles of k and v in shared memory and keeps a running
//      row max m[d], sum-exp l[d] and unnormalised context
//      P[d][e] = sum_n exp(k[d,n] - m[d]) v[e,n], rescaled by exp(m_old - m)
//      when the max grows (the online softmax). Each thread owns a 4x4
//      block of P over a quarter of the tile's columns; the quarters are
//      summed once at the end.
//   2. combine_context: grid B*h. Merges the chunks' (m, l, P) into
//      C[d][e] = scale * sum_c P_c exp(m_c - m) / (N * sum_c l_c exp(m_c - m)).
//   3. apply_context: grid (N / 256, B*h). One thread per column: softmax
//      of q over d in registers, then out[e] = sum_d C[d][e] s[d] with C in
//      shared memory, read as float4.
// The scratch (chunk partials and C) is allocated by the caller; its size
// is la_workspace_floats(). No tensor cores: the contractions are 32 deep
// and the kernel is bound by memory, not by arithmetic.
//
// q, k and v may each have any batch stride; within a batch element they
// must be contiguous (head stride d*N, row stride N). out is contiguous.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 32;                      // dim_head
constexpr int TILE = 128;                  // columns staged per tile
constexpr int CHUNK = 4 * TILE;            // columns per block of pass 1
constexpr int CTX_THREADS = 256;           // threads of pass 1
constexpr int GROUP_COLS = TILE / 4;       // columns per thread group of pass 1
constexpr int OUT_COLS = 256;              // columns (threads) per block of pass 3
constexpr int PARTIAL = 2 * D + D * D;     // m[D], l[D], P[D][D] per chunk

static_assert(4 * D * D <= D * (TILE + 1), "the reduction buffer reuses the k tile");
static_assert(OUT_COLS == D * D / 4, "pass 3 loads C with one float4 per thread");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
  const int grp = t / 64, d0 = (t % 64) / 8 * 4, e0 = (t % 8) * 4;
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
      const float f = fac[d0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= f;
    }
    for (int col = grp * GROUP_COLS; col < (grp + 1) * GROUP_COLS; ++col) {
      float kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = ks[d0 + i][col];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[e0 + j][col];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  float* red = &ks[0][0];  // the four column groups' P, summed below
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[grp * D * D + (d0 + i) * D + e0 + j] = acc[i][j];
  __syncthreads();
  float* out = partials + ((long long)bh * n_chunks + chunk) * PARTIAL;
  for (int idx = t; idx < D * D; idx += CTX_THREADS)
    out[2 * D + idx] = (red[idx] + red[D * D + idx]) + (red[2 * D * D + idx] + red[3 * D * D + idx]);
  if (t < D) {
    out[t] = m_run[t];
    out[D + t] = l_run[t];
  }
}

__global__ void __launch_bounds__(D * D)
combine_context(const float* __restrict__ partials, int n_chunks, int n, float scale,
                float* __restrict__ ctx) {
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
}

__global__ void __launch_bounds__(OUT_COLS)
apply_context(const float* __restrict__ q, long long q_bstride, int heads, int n,
              const float* __restrict__ ctx, float* __restrict__ out) {
  __shared__ float4 cs[D * D / 4];  // C[d][e], e fastest
  const int bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  cs[t] = reinterpret_cast<const float4*>(ctx + (long long)bh * D * D)[t];
  __syncthreads();
  const int col = blockIdx.x * OUT_COLS + t;
  if (col >= n) return;
  const float* qb = q + b * q_bstride + (long long)h * D * n + col;
  float s[D];
  float mx = -INFINITY;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s[d] = qb[(long long)d * n];
    mx = fmaxf(mx, s[d]);
  }
  float sum = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s[d] = expf(s[d] - mx);
    sum += s[d];
  }
  const float inv = 1.f / sum;
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
    ob[(long long)(4 * e4 + 0) * n] = a.x * inv;
    ob[(long long)(4 * e4 + 1) * n] = a.y * inv;
    ob[(long long)(4 * e4 + 2) * n] = a.z * inv;
    ob[(long long)(4 * e4 + 3) * n] = a.w * inv;
  }
}

int chunks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

}  // namespace

extern "C" {

// Floats of scratch that la_forward_f32 needs for B*h = bh and N = n.
long long la_workspace_floats(int bh, int n) {
  return (long long)bh * chunks_of(n) * PARTIAL + (long long)bh * D * D;
}

// Launches the three passes on `stream`; returns cudaGetLastError() after
// the first launch that fails, else 0. Pointers are device pointers; the
// workspace must hold la_workspace_floats(batch * heads, n) floats.
int la_forward_f32(const float* q, const float* k, const float* v, float* out,
                   float* workspace, long long q_bstride, long long k_bstride,
                   long long v_bstride, int batch, int heads, int n, float scale,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, n_chunks = chunks_of(n);
  float* partials = workspace;
  float* ctx = workspace + (long long)bh * n_chunks * PARTIAL;  // 16-byte aligned: PARTIAL % 4 == 0
  context_partials<<<dim3(n_chunks, bh), CTX_THREADS, 0, s>>>(k, v, k_bstride, v_bstride, heads,
                                                               n, n_chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_context<<<bh, D * D, 0, s>>>(partials, n_chunks, n, scale, ctx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_context<<<dim3((n + OUT_COLS - 1) / OUT_COLS, bh), OUT_COLS, 0, s>>>(q, q_bstride, heads,
                                                                              n, ctx, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
