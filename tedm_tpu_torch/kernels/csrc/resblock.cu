// The whole ResnetBlock, fp32 or bf16 activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tedm_tpu/ops/pallas/resblock.py: _kernel (its convolutions
// in _conv9), launched by _fwd_pallas behind fused_resnet_block. Over x (B, Cin, H, W), with
// the compute dtype T that of x:
//
//     h1  = conv3x3(x, W1) + b1                      T operands, fp32 sums, kept fp32
//     h1n = T(SiLU(FiLM(GroupNorm8(h1))))            statistics over the fp32 h1
//     h2  = conv3x3(h1n, W2) + b2                    T operands, fp32 sums, kept fp32
//     out = T(SiLU(GroupNorm8(h2)) + res)            res = conv1x1(x, Wres) + bres, or x
//
// with every cast where the plain version (kernels/resblock.py, resnet_block_reference) and
// the JAX reference (resblock.py:231-280) cast. The GroupNorm math is group_norm.cuh's.
//
// What bounds it: arithmetic. At the UNet's 128^2 stage (64 -> 64 channels, batch 8) the two
// 3x3 convolutions are 19.3 GFLOP against 33.6 MB of x and out in fp32 (0.29 ms at 67 TFLOP/s
// fp32, 10 us at 3.35 TB/s); over the 19 blocks of a forward 354 GFLOP, 5.3 ms.
//
// Design. The TPU kernel holds one image's whole (H*W, C) slab in VMEM and runs the block in
// one pass. A 128^2 x 64-channel fp32 slab is 4 MB, far over an SM's 227 KB of shared memory,
// so here the block is five launches, three of them one implicit-GEMM routine (conv_tile):
//   a. conv_tile<CONV1>: h1 = conv3x3(x) + b1, written fp32 to scratch, and per (channel,
//      8x8 tile) partial sums and sums of squares of h1 from its epilogue (one writer each);
//   b. gn_coefs: per (batch, group), the partials combined into mean and rstd, and per
//      (batch, channel) the affine of GN1 with the channel's FiLM scale and shift;
//   c. conv_tile<CONV2>: h2 = conv3x3(h1n) + b2, whose prologue applies GN1's affine and SiLU
//      to each h1 value it stages and rounds it to T; the zero padding stays zero (the padding
//      is of h1n, not of h1); partials of h2 as in (a);
//   d. gn_coefs for GN2 (no FiLM);
//   e. conv_tile<RESIDUAL> (a 1x1 conv of x, + bres) whose epilogue adds SiLU(GN2(h2)), or,
//      when Cin == Cout, finish_identity, which adds x. The sum is fp32, cast once to T.
// conv_tile: grid (8x8 pixel tiles, Cout / 64, B), 256 threads, each owning 4 output channels
// by 4 pixels of one tile row. Per step of 16 input channels, the block stages the input patch
// with its halo (16 x 10 x 10) and the weights (16 x 9 x 64, from a (Cin, taps, Cout) copy the
// wrapper makes, already rounded to T) in shared memory, and each thread does 9 x 16 x 16
// multiply-adds, read from registers. A step's sums are added to the running sum once, which
// keeps the fp32 error of a 6912-term sum near that of a 48-term one. All on the CUDA cores in
// fp32 FMA: bf16 operands are widened on load, so their products are exact and their sums
// fp32, as preferred_element_type=float32 gives, and fp32 takes no TF32. No tensor cores yet.
// x may have any batch stride; within a batch element it is contiguous. out is contiguous.

#include "group_norm.cuh"

namespace {

using gn::bf16;

constexpr int THREADS = 256;
constexpr int BM = 64;          // output channels per block
constexpr int TH = 8, TW = 8;   // an 8 x 8 tile of output pixels per block
constexpr int KC = 16;          // input channels per step
constexpr int EW_THREADS = 256;

enum Mode { CONV1, CONV2, RESIDUAL };

struct ConvArgs {
  const void* in;         // CONV1, RESIDUAL: x (T); CONV2: h1 (fp32)
  long long in_bstride;
  int cin, cout, h, w, tiles_x, tiles;
  const float* wt;        // (cin, taps, cout) fp32, values of T
  const float* bias;      // (cout,)
  const float2* coef;     // CONV2: GN1's affine (B, cin); RESIDUAL: GN2's (B, cout)
  const float* h2;        // RESIDUAL: h2 (B, cout, h, w)
  float* out_f;           // CONV1, CONV2: h (B, cout, h, w)
  float* sums;            // CONV1, CONV2: partials (B, cout, tiles)
  float* sqs;
  void* out;              // RESIDUAL: out (B, cout, h, w) in T
};

template <typename T, int TAPS, int MODE>
__global__ void __launch_bounds__(THREADS) conv_tile(ConvArgs a) {
  constexpr int R = TAPS == 9 ? 3 : 1;  // kernel side
  constexpr int HALO = R / 2;
  constexpr int PH = TH + 2 * HALO, PW = TW + 2 * HALO;
  __shared__ float xs[KC][PH * PW];
  __shared__ __align__(16) float ws[KC][TAPS][BM];

  const int tile = blockIdx.x, co0 = blockIdx.y * BM, b = blockIdx.z;
  const int y0 = (tile / a.tiles_x) * TH, x0 = (tile % a.tiles_x) * TW;
  const int t = threadIdx.x, pg = t % 16, tc = t / 16;
  const int py = pg / 2, px0 = (pg % 2) * 4;  // this thread's pixels: row py, columns px0..+3
  const long long plane = (long long)a.h * a.w;

  float acc[4][4] = {};
  for (int ci0 = 0; ci0 < a.cin; ci0 += KC) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = t; i < KC * PH * PW; i += THREADS) {
      const int c = i / (PH * PW), p = i % (PH * PW);
      const int ci = ci0 + c, yy = y0 - HALO + p / PW, xx = x0 - HALO + p % PW;
      float v = 0.f;  // the zero padding, of the conv's input
      if (ci < a.cin && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
        const long long off = b * a.in_bstride + ci * plane + (long long)yy * a.w + xx;
        if (MODE == CONV2)
          v = gn::round_to<T>(gn::silu_affine(static_cast<const float*>(a.in)[off],
                                              a.coef[(long long)b * a.cin + ci]));
        else
          v = gn::to_float(static_cast<const T*>(a.in)[off]);
      }
      xs[c][p] = v;
    }
    for (int i = t; i < KC * TAPS * (BM / 4); i += THREADS) {
      const int c = i / (TAPS * (BM / 4)), r = i % (TAPS * (BM / 4));
      const int tap = r / (BM / 4), co = co0 + 4 * (r % (BM / 4)), ci = ci0 + c;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci < a.cin && co < a.cout)  // cout % 4 == 0: all four are in range
        wv = *reinterpret_cast<const float4*>(a.wt + ((long long)ci * TAPS + tap) * a.cout + co);
      *reinterpret_cast<float4*>(&ws[c][tap][co - co0]) = wv;
    }
    __syncthreads();

    float part[4][4] = {};
#pragma unroll 2
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int dy = 0; dy < R; ++dy) {
        float row[4 + 2 * HALO];
#pragma unroll
        for (int i = 0; i < 4 + 2 * HALO; ++i) row[i] = xs[c][(py + dy) * PW + px0 + i];
#pragma unroll
        for (int dx = 0; dx < R; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&ws[c][dy * R + dx][4 * tc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            part[0][i] = fmaf(wv.x, row[i + dx], part[0][i]);
            part[1][i] = fmaf(wv.y, row[i + dx], part[1][i]);
            part[2][i] = fmaf(wv.z, row[i + dx], part[2][i]);
            part[3][i] = fmaf(wv.w, row[i + dx], part[3][i]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
  }

  const int y = y0 + py;
  float s[4] = {}, q[4] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + 4 * tc + j;
    if (co >= a.cout) continue;
    const float bias = a.bias[co];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = x0 + px0 + i;
      if (y >= a.h || x >= a.w) continue;
      const long long off = ((long long)b * a.cout + co) * plane + (long long)y * a.w + x;
      const float v = acc[j][i] + bias;
      if (MODE == RESIDUAL) {
        const float g = gn::silu_affine(a.h2[off], a.coef[(long long)b * a.cout + co]);
        static_cast<T*>(a.out)[off] = gn::from_float<T>(g + v);
      } else {
        a.out_f[off] = v;
        s[j] += v;
        q[j] = fmaf(v, v, q[j]);
      }
    }
  }
  if (MODE == RESIDUAL) return;
  // the 16 lanes of a half-warp share tc: sum their pixels, in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
    }
  if (pg == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * tc + j;
      if (co < a.cout) {
        a.sums[((long long)b * a.cout + co) * a.tiles + tile] = s[j];
        a.sqs[((long long)b * a.cout + co) * a.tiles + tile] = q[j];
      }
    }
}

// Per (batch, group): the group's statistics from the partials, then the affine of every
// channel of the group with its FiLM scale and shift (none when scale and shift are null).
template <typename TF>
__global__ void __launch_bounds__(THREADS)
gn_coefs(const float* __restrict__ sums, const float* __restrict__ sqs, int c, int groups,
         int tiles, float count, float eps, const float* __restrict__ gamma,
         const float* __restrict__ beta, const TF* __restrict__ scale,
         const TF* __restrict__ shift, long long film_stride, float2* __restrict__ coef) {
  __shared__ float red[32];
  const int g = blockIdx.x, b = blockIdx.y, cg = c / groups;
  const float2 stats = gn::group_stats(sums, sqs, b, g, c, groups, tiles, count, eps, red);
  for (int i = threadIdx.x; i < cg; i += blockDim.x) {
    const int ch = g * cg + i;
    const long long film = (long long)b * film_stride + ch;
    coef[(long long)b * c + ch] =
        gn::film_affine(stats, gamma[ch], beta[ch], scale ? gn::to_float(scale[film]) : 0.f,
                        shift ? gn::to_float(shift[film]) : 0.f);
  }
}

// out = T(SiLU(GN2(h2)) + x), the identity residual (Cin == Cout).
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
finish_identity(const float* __restrict__ h2, const float2* __restrict__ coef,
                const T* __restrict__ x, long long x_bstride, int c, long long plane,
                T* __restrict__ out) {
  const int bc = blockIdx.y;
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= plane) return;
  const long long off = (long long)bc * plane + i;
  const float g = gn::silu_affine(h2[off], coef[bc]);
  out[off] = gn::from_float<T>(g + gn::to_float(x[(bc / c) * x_bstride + (bc % c) * plane + i]));
}

int tiles_of(int h, int w) { return ((h + TH - 1) / TH) * ((w + TW - 1) / TW); }

#define RETURN_IF_FAILED()                     \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T, typename TF>
int launch(const void* x, long long x_bstride, int batch, int cin, int cout, int h, int w,
           const float* w1t, const float* b1, const float* g1, const float* be1,
           const void* scale, const void* shift, long long film_stride, const float* w2t,
           const float* b2, const float* g2, const float* be2, const float* wrest,
           const float* bres, int groups, float eps, float* workspace, void* out,
           cudaStream_t s) {
  const int tiles = tiles_of(h, w);
  const long long plane = (long long)h * w, act = (long long)batch * cout * plane;
  const long long part = (long long)batch * cout * tiles;
  float2* coef1 = reinterpret_cast<float2*>(workspace);
  float2* coef2 = coef1 + (long long)batch * cout;
  float* h1 = workspace + 4LL * batch * cout;
  float* h2 = h1 + act;
  float* sums1 = h2 + act;
  float* sqs1 = sums1 + part;
  float* sums2 = sqs1 + part;
  float* sqs2 = sums2 + part;
  const dim3 grid(tiles, (cout + BM - 1) / BM, batch);
  const float count = (float)(cout / groups) * (float)plane;

  ConvArgs a = {};
  a.cout = cout;
  a.h = h;
  a.w = w;
  a.tiles_x = (w + TW - 1) / TW;
  a.tiles = tiles;

  a.in = x;  // (a) conv1
  a.in_bstride = x_bstride;
  a.cin = cin;
  a.wt = w1t;
  a.bias = b1;
  a.out_f = h1;
  a.sums = sums1;
  a.sqs = sqs1;
  conv_tile<T, 9, CONV1><<<grid, THREADS, 0, s>>>(a);
  RETURN_IF_FAILED();
  gn_coefs<TF><<<dim3(groups, batch), THREADS, 0, s>>>(  // (b) GN1 with FiLM
      sums1, sqs1, cout, groups, tiles, count, eps, g1, be1, static_cast<const TF*>(scale),
      static_cast<const TF*>(shift), film_stride, coef1);
  RETURN_IF_FAILED();

  a.in = h1;  // (c) conv2 over GN1+SiLU(h1)
  a.in_bstride = cout * plane;
  a.cin = cout;
  a.wt = w2t;
  a.bias = b2;
  a.coef = coef1;
  a.out_f = h2;
  a.sums = sums2;
  a.sqs = sqs2;
  conv_tile<T, 9, CONV2><<<grid, THREADS, 0, s>>>(a);
  RETURN_IF_FAILED();
  gn_coefs<float><<<dim3(groups, batch), THREADS, 0, s>>>(  // (d) GN2
      sums2, sqs2, cout, groups, tiles, count, eps, g2, be2, nullptr, nullptr, 0, coef2);
  RETURN_IF_FAILED();

  if (wrest == nullptr) {  // (e) the residual
    finish_identity<T><<<dim3((unsigned)((plane + EW_THREADS - 1) / EW_THREADS), batch * cout),
                         EW_THREADS, 0, s>>>(h2, coef2, static_cast<const T*>(x), x_bstride,
                                             cout, plane, static_cast<T*>(out));
  } else {
    a.in = x;
    a.in_bstride = x_bstride;
    a.cin = cin;
    a.wt = wrest;
    a.bias = bres;
    a.coef = coef2;
    a.h2 = h2;
    a.out = out;
    conv_tile<T, 1, RESIDUAL><<<grid, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that rb_forward needs: two affines, h1 and h2, and their partials.
long long rb_workspace_floats(int batch, int cout, int h, int w) {
  const long long bc = (long long)batch * cout;
  return 4 * bc + 2 * bc * h * w + 4 * bc * tiles_of(h, w);
}

// Launches the block's passes on `stream`; returns cudaGetLastError() after the first launch
// that fails, else 0. x_bf16 says whether x and out are bf16 (else fp32); film_bf16 whether
// scale and shift are bf16 (else fp32; only with bf16 x); they may be null (no FiLM), and row
// b of each starts at b * film_stride. w1t (Cin, 9, Cout), w2t (Cout, 9, Cout) and wrest
// (Cin, 1, Cout) are fp32 holding values of x's dtype; wrest and bres are null for the
// identity residual (Cin == Cout). Biases, gains and shifts are fp32 (Cout,). Cout is a
// multiple of 4 and of groups. out is contiguous (B, Cout, H, W) in x's dtype. The workspace
// (16-byte aligned) holds rb_workspace_floats(batch, cout, h, w).
int rb_forward(int x_bf16, int film_bf16, const void* x, long long x_bstride, int batch, int cin,
               int cout, int h, int w, const float* w1t, const float* b1, const float* g1,
               const float* be1, const void* scale, const void* shift, long long film_stride,
               const float* w2t, const float* b2, const float* g2, const float* be2,
               const float* wrest, const float* bres, int groups, float eps, float* workspace,
               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return launch<float, float>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                                shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                                workspace, out, s);
  if (film_bf16)
    return launch<bf16, bf16>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                              shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                              workspace, out, s);
  return launch<bf16, float>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                             shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                             workspace, out, s);
}

}  // extern "C"
