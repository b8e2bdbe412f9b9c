// Flash cosine attention, fp32 or bf16 inputs, fp32 math, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tedm_tpu/ops/pallas/flash_attention.py: _flash_kernel,
// launched by _flash_pallas behind flash_cosine_attention. For each (batch, head), over q, k, v
// of shape (d = 32, N):
//
//     q' = q / max(|q_d|, 1e-12),  k' = k / max(|k_d|, 1e-12)   norms of each row over N
//     out[:, i] = sum_j softmax_j(scale * q'[:, i] . k'[:, j]) v[:, j]
//
// with the norms over the spatial axis N (_row_norms :36), as the reference normalises its
// (b, h, d, n) layout over its last axis. out is in q's dtype.
//
// What bounds it: at the UNet's mid stage (N = 256 at 128^2, batch 8) nothing much: q, k, v
// read and out written is 4 MB in fp32 (1.3 us at 3.35 TB/s) and the two N x N x d products
// 0.27 GFLOP (4 us at 67 TFLOP/s fp32); the launches' latency dominates. At N = 4096 (512^2
// inputs) the products take over, 64 GFLOP a call at batch 8.
//
// Design. The TPU kernel holds one (batch*head) row in VMEM and computes its norms there
// before its q tiles. Here two launches:
//   1. row_norms: one warp per row of q and of k (2 * B*heads*d rows), the sum of squares
//      over N. The norms need the whole row before any score exists.
//   2. flash_fwd: grid (N / 64, B*heads), one thread per query column. The thread holds its
//      column of q with scale / (|q_d| |k_d|) folded into each row d, its output accumulator
//      (32 floats) and the running max and sum of the online softmax. Key and value tiles of
//      64 columns are staged in shared memory; each chunk of 16 keys is scored, the running
//      max updated once, and the accumulator rescaled once. All on the CUDA cores in fp32 FMA:
//      the JAX kernel runs its products at Precision.HIGHEST, so no TF32 and no bf16 operands.
// q, k and v may each have any batch stride; within a batch element they are contiguous (head
// stride d*N, row stride N), so the three chunks of the qkv conv's output go in without a
// copy. out is contiguous.

#include "group_norm.cuh"

namespace {

using gn::bf16;

constexpr int D = 32;        // dim_head
constexpr int BQ = 64;       // query columns (threads) per block of pass 2
constexpr int BK = 64;       // key columns per staged tile
constexpr int KC = 16;       // keys per online-softmax step
constexpr int NORM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
row_norms(const T* __restrict__ q, const T* __restrict__ k, long long q_bstride,
          long long k_bstride, int heads, int n, int rows, float* __restrict__ norms) {
  const int row = blockIdx.x * (NORM_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= 2 * rows) return;
  const bool is_k = row >= rows;
  const int r = is_k ? row - rows : row;  // r = (b * heads + h) * D + d
  const int b = r / (heads * D), hd = r % (heads * D);
  const T* p = (is_k ? k + b * k_bstride : q + b * q_bstride) + (long long)hd * n;
  float ss = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float v = gn::to_float(p[i]);
    ss = fmaf(v, v, ss);
  }
  ss = gn::warp_sum(ss);
  if (lane == 0) norms[row] = fmaxf(sqrtf(ss), 1e-12f);
}

template <typename T>
__global__ void __launch_bounds__(BQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          long long q_bstride, long long k_bstride, long long v_bstride, int heads, int n,
          const float* __restrict__ norms, float scale, T* __restrict__ out) {
  __shared__ float ks[D][BK];
  __shared__ float vs[D][BK];
  __shared__ float fold[D];
  const int bh = blockIdx.y, t = threadIdx.x;
  const int b = bh / heads, h = bh % heads;
  const long long head = (long long)h * D * n;
  const T* qb = q + b * q_bstride + head;
  const T* kb = k + b * k_bstride + head;
  const T* vb = v + b * v_bstride + head;
  const int rows = gridDim.y * D;
  if (t < D) fold[t] = scale / (norms[bh * D + t] * norms[rows + bh * D + t]);
  __syncthreads();

  const int col = blockIdx.x * BQ + t;
  const bool live = col < n;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? gn::to_float(qb[(long long)d * n + col]) * fold[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int base = 0; base < n; base += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = t; i < D * BK; i += BQ) {
      const int d = i / BK, j = i % BK;
      const bool valid = base + j < n;
      ks[d][j] = valid ? gn::to_float(kb[(long long)d * n + base + j]) : 0.f;
      vs[d][j] = valid ? gn::to_float(vb[(long long)d * n + base + j]) : 0.f;
    }
    __syncthreads();
    const int kend = min(BK, n - base);
    for (int j0 = 0; j0 < kend; j0 += KC) {
      float s[KC];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], ks[d][j0 + j], a);
        s[j] = j0 + j < kend ? a : -INFINITY;  // a key past the end weighs exp(-inf) = 0
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);  // finite: key j0 is valid
      const float alpha = expf(m - m_new);  // 0 on the first step
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = fmaf(l, alpha, psum);
      m = m_new;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < KC; ++j) a = fmaf(s[j], vs[d][j0 + j], a);
        acc[d] = a;
      }
    }
  }
  if (!live) return;
  const float inv = 1.f / l;
  T* ob = out + (long long)bh * D * n + col;
#pragma unroll
  for (int d = 0; d < D; ++d) ob[(long long)d * n] = gn::from_float<T>(acc[d] * inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long q_bstride, long long k_bstride,
           long long v_bstride, int batch, int heads, int n, float scale, float* norms, void* out,
           cudaStream_t s) {
  const int rows = batch * heads * D;
  const int warps = NORM_THREADS / 32;
  row_norms<T><<<(2 * rows + warps - 1) / warps, NORM_THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), q_bstride, k_bstride, heads, n, rows,
      norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_fwd<T><<<dim3((n + BQ - 1) / BQ, batch * heads), BQ, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_bstride,
      k_bstride, v_bstride, heads, n, norms, scale, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that fa_forward needs: the norms of every row of q and k.
long long fa_workspace_floats(int batch, int heads) { return 2LL * batch * heads * D; }

// Launches the two passes on `stream`; returns cudaGetLastError() after the first launch that
// fails, else 0. q, k, v are (B, heads, 32, N) in bf16 if is_bf16, else fp32, each with its own
// batch stride and contiguous within a batch element; out is contiguous in the same dtype. The
// workspace holds fa_workspace_floats(batch, heads).
int fa_forward(int is_bf16, const void* q, const void* k, const void* v, long long q_bstride,
               long long k_bstride, long long v_bstride, int batch, int heads, int n, float scale,
               float* workspace, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k, v, q_bstride, k_bstride, v_bstride, batch, heads, n, scale,
                        workspace, out, s);
  return launch<float>(q, k, v, q_bstride, k_bstride, v_bstride, batch, heads, n, scale,
                       workspace, out, s);
}

}  // extern "C"
