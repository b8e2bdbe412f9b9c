// GroupNorm device code shared by the GroupNorm+FiLM+SiLU kernel (groupnorm.cu) and the
// ResnetBlock kernel (resblock.cu), for Hopper (sm_90a).
//
// The math is that of tedm_tpu/ops/pallas/groupnorm.py (_gn_kernel, :71-90): fp32 statistics
// of a group with the one-pass variance E[x^2] - mean^2 clamped at 0, then
//
//     y = x * a + b,   a = rstd * gamma * (scale + 1),
//                      b = (beta - mean * rstd * gamma) * (scale + 1) + shift,
//     out = SiLU(y) = y / (1 + exp(-y)).
//
// In NCHW a (batch, group) pair is one contiguous span of channels, so statistics are kept as
// per-(batch, channel, tile) partial sums and sums of squares, laid out (B, C, tiles): the
// partials of one group are then one contiguous run of (C / groups) * tiles entries. Partials
// are written by one thread each, in a fixed order, and combined in a fixed order: the
// statistics are the same from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and widened back: the value an operand of type T holds
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum of v over the block, returned to every thread. blockDim.x is a multiple of 32;
// red holds 32 floats of shared memory. Two calls in a row are safe.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // an earlier call has read red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// (mean, rstd) of group g of batch element b, from the partials sums and sqs laid out
// (B, C, tiles), over `count` elements. Called by every thread of the block; returned to each.
__device__ __forceinline__ float2 group_stats(const float* __restrict__ sums,
                                              const float* __restrict__ sqs, int b, int g, int c,
                                              int groups, int tiles, float count, float eps,
                                              float* red) {
  const int cg = c / groups;
  const long long base = ((long long)b * c + (long long)g * cg) * tiles;
  const int n = cg * tiles;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s += sums[base + i];
    q += sqs[base + i];
  }
  s = block_sum(s, red);
  q = block_sum(q, red);
  const float mean = s / count;
  const float var = fmaxf(q / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The per-channel affine (a, b) of the epilogue, from the group's (mean, rstd), the channel's
// gamma and beta and its FiLM scale and shift (0 and 0 without FiLM).
__device__ __forceinline__ float2 film_affine(float2 stats, float gamma, float beta, float scale,
                                              float shift) {
  const float film = scale + 1.f;
  return make_float2(stats.y * gamma * film, (beta - stats.x * stats.y * gamma) * film + shift);
}

// SiLU(x * a + b)
__device__ __forceinline__ float silu_affine(float x, float2 ab) {
  const float y = fmaf(x, ab.x, ab.y);
  return y / (1.f + expf(-y));
}

// d SiLU(y) / dy = s (1 + y (1 - s)), s = sigmoid(y)
__device__ __forceinline__ float silu_grad(float y) {
  const float s = 1.f / (1.f + expf(-y));
  return s * fmaf(y, 1.f - s, 1.f);
}

}  // namespace gn
