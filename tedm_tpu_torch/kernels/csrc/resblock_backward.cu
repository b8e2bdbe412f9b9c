// The GroupNorm (+ FiLM) + SiLU passes of the whole ResnetBlock's backward, fp32 or bf16, for
// Hopper (sm_90a).
//
// Replaces the backward of tedm_tpu/ops/pallas/resblock.py's fused_resnet_block: _block_bwd,
// jax.vjp of resnet_block_reference (which XLA compiles; the TPU kernel has no Pallas
// backward). The block's forward (resblock.cu) leaves, per batch element b and channel c, the
// fp32 conv outputs h1 and h2, their GroupNorm statistics (mean, rstd) per (b, group) and the
// affine (a, b') of each GroupNorm's epilogue, f = a h + b'. Over that, kernels/resblock.py runs
//
//     GN2 + SiLU backward (here)       dout -> dh2, dg2, dbe2, db2, dbres; and h1n rebuilt
//     conv2 data and weight gradients  torch's convolution_backward in the compute dtype
//     GN1 + FiLM + SiLU backward (here) dh1n -> dh1, dg1, dbe1, db1, dscale, dshift
//     conv1 and the 1x1 residual       convolution_backward; dx summed in the compute dtype
//
// (the JAX package leaves the convolutions' transposes to XLA, outside any Pallas kernel, as the
// port leaves them to cuDNN). With da the gradient of the GroupNorm's output a = SiLU(f),
// xhat = (h - mean) rstd, film = scale + 1 (1 without FiLM), k = film gamma:
//
//     df   = da SiLU'(f)                       dshift = sum_p df, dscale = sum_p df (xhat gamma + beta)
//     dgamma = sum_{b,p} film df xhat          dbeta  = sum_{b,p} film df
//     dh   = rstd (k df - m1 - xhat m2),  m1 = mean_group(k df), m2 = mean_group(k df xhat)
//     db   = sum_{b,p} dh                      the bias of the conv before the GroupNorm
//
// so every reduction is a sum over one (b, c) plane of S1 = sum df, S2 = sum df xhat and
// S3 = sum xhat (db = sum_b P S1 + Q S3 + R HW with dh = P df + Q xhat + R), and for GN2 also
// S0 = sum dout (dbres). All in fp32. dh is written in the compute dtype T, the operand of the
// conv backward that follows (a bf16 conv backward rounds its output gradient to bf16, as the
// TPU's single bf16 pass does); db, dgamma, dbeta, dscale, dshift are fp32 sums of the fp32
// values. h1n = T(SiLU(FiLM(GN1(h1)))) is rebuilt by the same function as the forward's conv2
// prologue, bit for bit, and its zero padding is the conv's own (the padding pads h1n, not h1).
//
// What bounds it: memory. Per GroupNorm it reads h (fp32) and da (T) twice and writes dh (T),
// and for GN2 reads h1 and writes h1n: at (16, 64, 128^2) in bf16 about 0.16 GB for both GNs,
// 49 us at 3.35 TB/s. Over the 19 blocks of a training step (batch 16) 1.2 ms; the step's
// convolution gradients are some 30 times that on cuDNN.
//
// Design: three launches per GroupNorm, all deterministic (one writer each, fixed orders):
//   1. gn_bwd_reduce: grid (spans of 2048 pixels, B*C); a block reads its span of one (b, c)
//      plane, 4 pixels a thread a step by vector loads, and writes (S1, S2, S3, S0);
//   2. gn_bwd_coefs: grid (groups); a block walks the batch, sums its channels' spans, takes the
//      group means m1 and m2 by block sums, writes each (b, c)'s (P, Q, R), dscale and dshift,
//      and accumulates dgamma, dbeta, db and dbres over b in registers;
//   3. gn_bwd_apply: grid (spans of 1024 pixels, B*C); dh = P df + Q xhat + R, and for GN2 h1n.
// h, da, dh and h1n are contiguous (B, C, H, W).

#include <stdint.h>

#include "group_norm.cuh"

namespace {

using gn::bf16;

constexpr int THREADS = 256;
constexpr int REDUCE_SPAN = 8 * THREADS;  // pixels of one plane a reduce block walks
constexpr int APPLY_SPAN = 4 * THREADS;   // pixels of one plane an apply block writes

// 4 values of T in one 16- or 8-byte access
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<bf16> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  const typename Vec4<T>::type raw = *reinterpret_cast<const typename Vec4<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = gn::to_float(e[k]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  typename Vec4<T>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = gn::from_float<T>(v[k]);
  *reinterpret_cast<typename Vec4<T>::type*>(p) = raw;
}

// One (b, c) plane's GroupNorm quantities: f's affine, the group's (mean, rstd)
struct Plane {
  float2 ab, st;
  __device__ __forceinline__ float df(float h, float da) const {
    return da * gn::silu_grad(fmaf(h, ab.x, ab.y));
  }
  __device__ __forceinline__ float xhat(float h) const { return (h - st.x) * st.y; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_bwd_reduce(const float* __restrict__ h, const T* __restrict__ da,
              const float2* __restrict__ coef, const float2* __restrict__ stats, int c, int cg,
              long long plane, int spans, int vec, float4* __restrict__ part) {
  __shared__ float red[32];
  const int bc = blockIdx.y, tid = threadIdx.x;
  const Plane pl{coef[bc], stats[(bc / c) * (c / cg) + (bc % c) / cg]};
  const long long base = (long long)bc * plane, p0 = (long long)blockIdx.x * REDUCE_SPAN;
  const long long p1 = min(p0 + REDUCE_SPAN, plane);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  auto add = [&](float hv, float dv) {
    const float df = pl.df(hv, dv), xh = pl.xhat(hv);
    s0 += dv;
    s1 += df;
    s2 = fmaf(df, xh, s2);
    s3 += xh;
  };
  if (vec) {
    for (long long i = p0 + 4 * tid; i < p1; i += 4 * THREADS) {
      const float4 hv = *reinterpret_cast<const float4*>(h + base + i);
      float dv[4];
      load4(da + base + i, dv);
      add(hv.x, dv[0]);
      add(hv.y, dv[1]);
      add(hv.z, dv[2]);
      add(hv.w, dv[3]);
    }
  } else {
    for (long long i = p0 + tid; i < p1; i += THREADS) add(h[base + i], gn::to_float(da[base + i]));
  }
  s1 = gn::block_sum(s1, red);
  s2 = gn::block_sum(s2, red);
  s3 = gn::block_sum(s3, red);
  s0 = gn::block_sum(s0, red);
  if (tid == 0) part[(long long)bc * spans + blockIdx.x] = make_float4(s1, s2, s3, s0);
}

// One block a group; thread i < cg is channel g cg + i. blockDim.x is cg rounded up to 32.
template <typename TF>
__global__ void __launch_bounds__(1024)
gn_bwd_coefs(const float4* __restrict__ part, int spans, const float2* __restrict__ stats,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const TF* __restrict__ scale, const TF* __restrict__ shift, long long film_stride,
             int batch, int c, int groups, float plane, float4* __restrict__ pqr,
             float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ dbias,
             float* __restrict__ dscale, float* __restrict__ dshift, float* __restrict__ dsum) {
  __shared__ float red[32];
  const int g = blockIdx.x, cg = c / groups, ch = g * cg + threadIdx.x;
  const bool live = threadIdx.x < cg;
  const float gam = live ? gamma[ch] : 0.f, bet = live ? beta[ch] : 0.f;
  const float count = (float)cg * plane;
  float acc_g = 0.f, acc_be = 0.f, acc_b = 0.f, acc_sum = 0.f;
  for (int b = 0; b < batch; ++b) {
    const long long bc = (long long)b * c + ch;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      for (int i = 0; i < spans; ++i) {
        const float4 p = part[bc * spans + i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
    const long long film_at = (long long)b * film_stride + ch;
    const float film = live && scale ? gn::to_float(scale[film_at]) + 1.f : 1.f;
    const float k = film * gam;
    const float m1 = gn::block_sum(k * s.x, red) / count;
    const float m2 = gn::block_sum(k * s.y, red) / count;
    if (!live) continue;
    const float rstd = stats[b * groups + g].y;
    const float p = rstd * k, q = -rstd * m2, r = -rstd * m1;
    pqr[bc] = make_float4(p, q, r, 0.f);
    acc_b += fmaf(p, s.x, fmaf(q, s.z, r * plane));
    acc_g = fmaf(film, s.y, acc_g);
    acc_be = fmaf(film, s.x, acc_be);
    acc_sum += s.w;
    if (dscale) dscale[bc] = fmaf(gam, s.y, bet * s.x);
    if (dshift) dshift[bc] = s.x;
  }
  if (!live) return;
  dgamma[ch] = acc_g;
  dbeta[ch] = acc_be;
  dbias[ch] = acc_b;
  if (dsum) dsum[ch] = acc_sum;
}

template <typename T, bool H1N>
__global__ void __launch_bounds__(THREADS)
gn_bwd_apply(const float* __restrict__ h, const T* __restrict__ da,
             const float2* __restrict__ coef, const float2* __restrict__ stats,
             const float4* __restrict__ pqr, int c, int cg, long long plane, int vec,
             T* __restrict__ dh, const float* __restrict__ h1, const float2* __restrict__ coef1,
             T* __restrict__ h1n) {
  const int bc = blockIdx.y;
  const Plane pl{coef[bc], stats[(bc / c) * (c / cg) + (bc % c) / cg]};
  const float4 k = pqr[bc];
  const float2 ab1 = H1N ? coef1[bc] : make_float2(0.f, 0.f);
  const long long base = (long long)bc * plane, p0 = (long long)blockIdx.x * APPLY_SPAN;
  auto grad = [&](float hv, float dv) { return fmaf(k.x, pl.df(hv, dv), fmaf(k.y, pl.xhat(hv), k.z)); };
  if (vec) {
    const long long i = base + p0 + 4 * threadIdx.x;
    if (p0 + 4 * threadIdx.x >= plane) return;
    const float4 hv = *reinterpret_cast<const float4*>(h + i);
    float dv[4];
    load4(da + i, dv);
    const float out[4] = {grad(hv.x, dv[0]), grad(hv.y, dv[1]), grad(hv.z, dv[2]), grad(hv.w, dv[3])};
    store4(dh + i, out);
    if constexpr (H1N) {
      const float4 v = *reinterpret_cast<const float4*>(h1 + i);
      const float n[4] = {gn::silu_affine(v.x, ab1), gn::silu_affine(v.y, ab1),
                          gn::silu_affine(v.z, ab1), gn::silu_affine(v.w, ab1)};
      store4(h1n + i, n);
    }
    return;
  }
  const long long p1 = min(p0 + APPLY_SPAN, plane);
  for (long long p = p0 + threadIdx.x; p < p1; p += THREADS) {
    const long long i = base + p;
    dh[i] = gn::from_float<T>(grad(h[i], gn::to_float(da[i])));
    if constexpr (H1N) h1n[i] = gn::from_float<T>(gn::silu_affine(h1[i], ab1));
  }
}

int spans_of(long long plane) { return (int)((plane + REDUCE_SPAN - 1) / REDUCE_SPAN); }

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename TF>
int launch(const float* h, const T* da, const float2* coef, const float2* stats,
           const float* gamma, const float* beta, const TF* scale, const TF* shift,
           long long film_stride, int batch, int c, int groups, long long plane, float* workspace,
           float* dgamma, float* dbeta, float* dbias, float* dscale, float* dshift, float* dsum,
           T* dh, const float* h1, const float2* coef1, T* h1n, cudaStream_t s) {
  const int cg = c / groups, spans = spans_of(plane);
  float4* part = reinterpret_cast<float4*>(workspace);
  float4* pqr = part + (long long)batch * c * spans;
  const int vec = plane % 4 == 0 && aligned16(h) && aligned16(da) && aligned16(dh) &&
                  aligned16(h1) && aligned16(h1n);
  gn_bwd_reduce<T><<<dim3(spans, batch * c), THREADS, 0, s>>>(h, da, coef, stats, c, cg, plane,
                                                              spans, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_coefs<TF><<<groups, (cg + 31) / 32 * 32, 0, s>>>(
      part, spans, stats, gamma, beta, scale, shift, film_stride, batch, c, groups, (float)plane,
      pqr, dgamma, dbeta, dbias, dscale, dshift, dsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((plane + APPLY_SPAN - 1) / APPLY_SPAN), batch * c);
  if (h1n)
    gn_bwd_apply<T, true><<<grid, THREADS, 0, s>>>(h, da, coef, stats, pqr, c, cg, plane, vec, dh,
                                                   h1, coef1, h1n);
  else
    gn_bwd_apply<T, false><<<grid, THREADS, 0, s>>>(h, da, coef, stats, pqr, c, cg, plane, vec, dh,
                                                    nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that rb_gn_backward needs: the plane partials and the (P, Q, R) of each plane.
long long rb_gn_backward_floats(int batch, int c, long long plane) {
  return 4LL * batch * c * (spans_of(plane) + 1);
}

// One GroupNorm's backward over h (B, c, plane) fp32 with the forward's affine coef (B, c) and
// statistics (B, groups), both float2 (rb_saved_floats' layout), and da, the gradient of its
// output, in the compute dtype (bf16 if t_bf16, else fp32). scale and shift (FiLM rows of stride
// film_stride, bf16 if film_bf16, else fp32) may be null. Writes dh (compute dtype) and fp32
// dgamma, dbeta, dbias (c,), and where not null dscale, dshift (B, c) and dsum = sum of da over
// (b, pixels) (c,). With h1n not null, also h1n = T(SiLU(h1 coef1.x + coef1.y)). c is a multiple
// of groups with c / groups <= 1024. The workspace (16-byte aligned) holds rb_gn_backward_floats.
// Returns the first CUDA error, else 0.
int rb_gn_backward(int t_bf16, int film_bf16, const float* h, const void* da, const float2* coef,
                   const float2* stats, const float* gamma, const float* beta, const void* scale,
                   const void* shift, long long film_stride, int batch, int c, int groups,
                   long long plane, float* workspace, float* dgamma, float* dbeta, float* dbias,
                   float* dscale, float* dshift, float* dsum, void* dh, const float* h1,
                   const float2* coef1, void* h1n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!t_bf16)
    return launch<float, float>(h, static_cast<const float*>(da), coef, stats, gamma, beta,
                                static_cast<const float*>(scale), static_cast<const float*>(shift),
                                film_stride, batch, c, groups, plane, workspace, dgamma, dbeta,
                                dbias, dscale, dshift, dsum, static_cast<float*>(dh), h1, coef1,
                                static_cast<float*>(h1n), s);
  if (film_bf16)
    return launch<bf16, bf16>(h, static_cast<const bf16*>(da), coef, stats, gamma, beta,
                              static_cast<const bf16*>(scale), static_cast<const bf16*>(shift),
                              film_stride, batch, c, groups, plane, workspace, dgamma, dbeta,
                              dbias, dscale, dshift, dsum, static_cast<bf16*>(dh), h1, coef1,
                              static_cast<bf16*>(h1n), s);
  return launch<bf16, float>(h, static_cast<const bf16*>(da), coef, stats, gamma, beta,
                             static_cast<const float*>(scale), static_cast<const float*>(shift),
                             film_stride, batch, c, groups, plane, workspace, dgamma, dbeta, dbias,
                             dscale, dshift, dsum, static_cast<bf16*>(dh), h1, coef1,
                             static_cast<bf16*>(h1n), s);
}

}  // extern "C"
