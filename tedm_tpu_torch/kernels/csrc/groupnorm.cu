// GroupNorm(groups) -> FiLM -> SiLU, fp32 or bf16 activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tedm_tpu/ops/pallas/groupnorm.py: _gn_kernel, launched by
// _fwd_pallas behind fused_group_norm_film_silu. Over x (B, C, H, W):
//
//     out = SiLU((GroupNorm(x) * gamma + beta) * (scale + 1) + shift)
//
// with fp32 statistics (the one-pass E[x^2] - mean^2 clamped at 0, eps) and the epilogue of
// group_norm.cuh; out in x's dtype. scale and shift are (B, C) rows with a row stride of their
// own (the halves of the time MLP's (B, 2C) output), fp32 or bf16, or absent.
//
// What bounds it: memory. It must read x and write out, 2 * B*C*H*W elements, for about 10
// operations an element: at (8, 64, 128, 128) in fp32 that is 67 MB, 20 us at 3.35 TB/s.
//
// Design. The TPU kernel holds one image's whole (H*W, C) slab in VMEM and reads it twice
// there. On the H100 one block per (batch, group) would give 64 blocks at batch 8, half the
// SMs, each walking up to 512 KB, so the work is split over many blocks in two launches:
//   1. gn_partials: grid (B*C, tiles of 2048 elements of one channel). A block sums x and x^2
//      over its tile in fp32 (coalesced loads, 8 a thread) and writes the two partials, laid
//      out (B, C, tiles) as group_norm.cuh expects.
//   2. gn_apply: the same grid. Each block combines its group's (C / groups) * tiles partials
//      (64 or fewer on the UNet) into mean and rstd, forms its channel's affine, and applies
//      it with SiLU to its tile. x is read twice from device memory; the second read of a tile
//      often hits the 50 MB L2.
// x may have any batch stride; within a batch element it is contiguous. out is contiguous.

#include "group_norm.cuh"

namespace {

using gn::bf16;

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;  // elements of one channel per block

template <typename TX>
__global__ void __launch_bounds__(THREADS)
gn_partials(const TX* __restrict__ x, long long x_bstride, int c, int hw, int tiles,
            float* __restrict__ sums, float* __restrict__ sqs) {
  __shared__ float red[32];
  const int bc = blockIdx.x, tile = blockIdx.y;
  const TX* row = x + (bc / c) * x_bstride + (long long)(bc % c) * hw;
  const int end = min((tile + 1) * TILE, hw);
  float s = 0.f, q = 0.f;
  for (int i = tile * TILE + threadIdx.x; i < end; i += THREADS) {
    const float v = gn::to_float(row[i]);
    s += v;
    q = fmaf(v, v, q);
  }
  s = gn::block_sum(s, red);
  q = gn::block_sum(q, red);
  if (threadIdx.x == 0) {
    sums[(long long)bc * tiles + tile] = s;
    sqs[(long long)bc * tiles + tile] = q;
  }
}

template <typename TX, typename TF>
__global__ void __launch_bounds__(THREADS)
gn_apply(const TX* __restrict__ x, long long x_bstride, const float* __restrict__ gamma,
         const float* __restrict__ beta, const TF* __restrict__ scale, const TF* __restrict__ shift,
         long long film_stride, int c, int groups, int hw, int tiles, float eps,
         const float* __restrict__ sums, const float* __restrict__ sqs, TX* __restrict__ out) {
  __shared__ float red[32];
  const int bc = blockIdx.x, tile = blockIdx.y;
  const int b = bc / c, ch = bc % c;
  const float2 stats = gn::group_stats(sums, sqs, b, ch / (c / groups), c, groups, tiles,
                                       (float)(c / groups) * (float)hw, eps, red);
  const long long film = (long long)b * film_stride + ch;
  const float2 ab = gn::film_affine(stats, gamma[ch], beta[ch],
                                    scale ? gn::to_float(scale[film]) : 0.f,
                                    shift ? gn::to_float(shift[film]) : 0.f);
  const TX* row = x + b * x_bstride + (long long)ch * hw;
  TX* orow = out + (long long)bc * hw;
  const int end = min((tile + 1) * TILE, hw);
  for (int i = tile * TILE + threadIdx.x; i < end; i += THREADS)
    orow[i] = gn::from_float<TX>(gn::silu_affine(gn::to_float(row[i]), ab));
}

int tiles_of(int hw) { return (hw + TILE - 1) / TILE; }

template <typename TX, typename TF>
int launch(const void* x, long long x_bstride, const float* gamma, const float* beta,
           const void* scale, const void* shift, long long film_stride, int batch, int c,
           int groups, int hw, float eps, float* workspace, void* out, cudaStream_t s) {
  const int tiles = tiles_of(hw);
  float* sums = workspace;
  float* sqs = workspace + (long long)batch * c * tiles;
  const dim3 grid(batch * c, tiles);
  gn_partials<TX><<<grid, THREADS, 0, s>>>(static_cast<const TX*>(x), x_bstride, c, hw, tiles,
                                           sums, sqs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply<TX, TF><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), x_bstride, gamma, beta, static_cast<const TF*>(scale),
      static_cast<const TF*>(shift), film_stride, c, groups, hw, tiles, eps, sums, sqs,
      static_cast<TX*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that gn_forward needs.
long long gn_workspace_floats(int batch, int c, int hw) {
  return 2LL * batch * c * tiles_of(hw);
}

// Launches the two passes on `stream`; returns cudaGetLastError() after the first launch that
// fails, else 0. x_bf16 says whether x and out are bf16 (else fp32); film_bf16 whether scale
// and shift are bf16 (else fp32; only with bf16 x). scale and shift may each be null (no FiLM
// term); row b of each starts at b * film_stride. gamma and beta are fp32 (C,). out is
// contiguous (B, C, H, W) in x's dtype. The workspace holds gn_workspace_floats(...).
int gn_forward(int x_bf16, int film_bf16, const void* x, long long x_bstride, const float* gamma,
               const float* beta, const void* scale, const void* shift, long long film_stride,
               int batch, int c, int groups, int hw, float eps, float* workspace, void* out,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return launch<float, float>(x, x_bstride, gamma, beta, scale, shift, film_stride, batch, c,
                                groups, hw, eps, workspace, out, s);
  if (film_bf16)
    return launch<bf16, bf16>(x, x_bstride, gamma, beta, scale, shift, film_stride, batch, c,
                              groups, hw, eps, workspace, out, s);
  return launch<bf16, float>(x, x_bstride, gamma, beta, scale, shift, film_stride, batch, c,
                             groups, hw, eps, workspace, out, s);
}

}  // extern "C"
