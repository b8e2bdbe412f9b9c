// The whole ResnetBlock, fp32 or bf16 activations, on Hopper's tensor cores (sm_90a).
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
// 3x3 convolutions are 19.3 GFLOP against 33.6 MB of x and out in fp32; over the 19 blocks of
// a forward 354 GFLOP: 0.36 ms on the bf16 tensor cores (989 TFLOP/s), and in fp32, which runs
// three TF32 products for each product (below), 2.15 ms at 495 TFLOP/s.
//
// Design. The TPU kernel holds one image's whole (H*W, C) slab in VMEM and runs the block in
// one pass. A 128^2 x 64-channel fp32 slab is 4 MB, far over an SM's 227 KB of shared memory,
// so here the block is five launches, three of them one implicit-GEMM routine (conv_tc):
//   a. conv_tc<CONV1>: h1 = conv3x3(x) + b1, written fp32 to scratch, and per (channel, 8x8
//      tile) partial sums and sums of squares of h1 from its epilogue (one writer each);
//   b. gn_coefs: per (batch, group), the partials combined into mean and rstd (kept for the
//      backward), and per (batch, channel) the affine of GN1 with the channel's FiLM scale and
//      shift;
//   c. conv_tc<CONV2>: h2 = conv3x3(h1n) + b2, whose prologue applies GN1's affine and SiLU to
//      each h1 value it stages and rounds it to T; the zero padding stays zero (the padding is
//      of h1n, not of h1); partials of h2 as in (a);
//   d. gn_coefs for GN2 (no FiLM);
//   e. the residual, a 1x1 conv of x (+ bres) whose epilogue adds SiLU(GN2(h2)): res_tc, its A
//      straight from x's rows by bulk copies, where use_res_tc says it is faster, else
//      conv_tc<RESIDUAL>; or, when Cin == Cout, finish_identity, which adds x. The sum is fp32,
//      cast once to T.
// conv_tc is an implicit GEMM on the tensor cores: M = 64 output pixels (an 8x8 tile), N = 64
// output channels, K = Cin x taps; a warpgroup (128 threads) an 8x8 tile, two stacked in y a
// block where that leaves enough blocks (launch_conv), two blocks an SM.
//   - Mainloop: wgmma m64n64, k16 in bf16 or k8 in TF32, accumulators in registers. Per chunk
//     of KC input channels (32 in bf16, 8 in fp32) the block stages the input patch with its
//     halo (10x10 pixels for 3x3) [pixel][channel], channels contiguous, which transposes NCHW
//     on the way in; each tap's A fragment is the patch shifted by the tap, a window that is no
//     canonical wgmma tile, so A comes from registers, loaded by ldmatrix (pixels padded to
//     80 or 48 bytes: conflict-free). conv2's prologue (GN1 + FiLM + SiLU on the fp32 h1, then
//     the rounding to T) is why A cannot be a plain copy either.
//   - B, the weights, in the wgmma no-swizzle K-major layout (tensor_core.cuh), laid out once
//     per parameter version by the wrapper so that a chunk's weights for all taps are one
//     contiguous run: one bulk async copy (cp.async.bulk, completion on an mbarrier) a chunk,
//     double-buffered, issued a chunk ahead of its products. The next chunk's patch is loaded
//     into registers before the current chunk's products and stored after them.
//   - A fragments are double-buffered in registers across taps: each tap's products are one
//     wgmma group, and the wait for all but the newest group frees the previous tap's registers.
//   - bf16: bf16 operands straight in. fp32: split TF32, a = hi + lo, three products
//     lo*hi + hi*lo + hi*hi; the weights' hi and lo are two planes of the layout, the patch is
//     split in registers. The JAX kernel keeps fp32 products exact to fp32 (the 2e-5 gate, TF32
//     off), and one TF32 product would miss the gate by far (tests/test_torch_resblock.py).
//   - Epilogue: bias, the fp32 h1/h2 stores, and the per-(channel, tile) GroupNorm partials:
//     the accumulator rows (pixels) of a channel are summed over the 8 lanes that hold them by
//     shuffles, then over the 4 warps in shared memory in a fixed order, one writer each:
//     deterministic, no atomics. Or, for the residual, GN2 + SiLU + the add and the cast.
// Enough blocks: at the deepest, narrowest call (16^2, 768 -> 512 channels) batch 8 gives
// 4 tiles x 8 channel blocks x 8 = 256 blocks for 132 SMs.
// h1, h2, the two affines and the group statistics go to the `saved` buffer (rb_saved_floats),
// which the wrapper keeps for the backward (resblock_backward.cu) when autograd needs the block;
// the partials go to `scratch`.
// x may have any batch stride; within a batch element it is contiguous. out is contiguous.

#include <type_traits>

#include "group_norm.cuh"
#include "tensor_core.cuh"

namespace {

using gn::bf16;

constexpr int WG_THREADS = 128;                   // a warpgroup
constexpr int BN = 64;                            // output channels per block: the wgmma's N
constexpr int TH = 8, TW = 8;                     // 8x8 output pixels per warpgroup: its M = 64
constexpr int KSTEP_BYTES = (BN / 8) * 2 * 128;   // one k-step of B: 8 x 2 core matrices
constexpr int EW_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Per compute dtype: input channels per chunk, k-steps a tap (32 bytes of channels each) and
// planes of the weight layout (TF32 hi and lo for fp32).
template <typename T>
struct Geo;
template <>
struct Geo<bf16> {
  static constexpr int KC = 32, KSTEPS = 2, PLANES = 1;
};
template <>
struct Geo<float> {
  static constexpr int KC = 8, KSTEPS = 1, PLANES = 2;
};

constexpr int align128(int bytes) { return (bytes + 127) & ~127; }

// Shared memory of conv_tc: two B stages, two patch stages, two barriers, the GN partials (and,
// for CONV2, GN1's affine of every input channel). TY warpgroups a block, each an 8x8 tile,
// stacked in y.
template <typename T, int TAPS, int TY>
struct Smem {
  using G = Geo<T>;
  static constexpr int THREADS = WG_THREADS * TY;
  static constexpr int R = TAPS == 9 ? 3 : 1, HALO = R / 2;
  static constexpr int PH = TY * TH + 2 * HALO, PW = TW + 2 * HALO, PIXELS = PH * PW;
  static constexpr int PIX = 32 * G::KSTEPS + 16;  // bytes a staged pixel, 16 of them padding
  static constexpr int A = align128(PIXELS * PIX);
  static constexpr int B = G::PLANES * TAPS * G::KSTEPS * KSTEP_BYTES;
  static constexpr int BYTES = 2 * B + 2 * A + 16 + TY * 4 * BN * 2 * 4;  // + 8 * cin for CONV2
};

enum Mode { CONV1, CONV2, RESIDUAL };

struct ConvArgs {
  const void* in;         // CONV1, RESIDUAL: x (T); CONV2: h1 (fp32)
  long long in_bstride;
  int cin, cout, h, w, tiles_x, tiles;
  const void* wt;         // the weights in the tensor-core layout (kernels/resblock.py)
  const float* bias;      // (cout,)
  const float2* coef;     // CONV2: GN1's affine (B, cin); RESIDUAL: GN2's (B, cout)
  const float* h2;        // RESIDUAL: h2 (B, cout, h, w)
  float* out_f;           // CONV1, CONV2: h (B, cout, h, w)
  float* sums;            // CONV1, CONV2: partials (B, cout, tiles)
  float* sqs;
  void* out;              // RESIDUAL: out (B, cout, h, w) in T
};

template <typename T, int TAPS, int MODE, int TY>
__global__ void __launch_bounds__(WG_THREADS * TY, 2) conv_tc(ConvArgs a) {
  using G = Geo<T>;
  using S = Smem<T, TAPS, TY>;
  constexpr int THREADS = S::THREADS;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bsm = smem;                 // [2][B]
  unsigned char* patch = smem + 2 * S::B;    // [2][A]
  uint64_t* bar = reinterpret_cast<uint64_t*>(patch + 2 * S::A);
  float* red = reinterpret_cast<float*>(bar + 2);  // [TY x 4 warps][BN][sum, sum of squares]

  // the block's TY tiles (8x8, the GN partials' unit) are tile rows TY by .. TY by + TY - 1 of
  // tile column tx; warpgroup wg computes tile row TY by + wg
  const int by = blockIdx.x / a.tiles_x, tx = blockIdx.x % a.tiles_x, co0 = blockIdx.y * BN;
  const int b = blockIdx.z, y0 = by * TY * TH, x0 = tx * TW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wg = warp / 4, wwarp = warp % 4;
  const int cin = a.cin, cout = a.cout, h = a.h, w = a.w;
  const long long plane = (long long)h * w;
  const int chunks = (cin + G::KC - 1) / G::KC;
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(a.wt) + (long long)blockIdx.y * chunks * S::B;
  float2* cf = reinterpret_cast<float2*>(red + TY * 4 * BN * 2);  // CONV2: GN1's affine, (cin,)

  if (tid == 0) {
    tc::mbar_init(&bar[0], 1);
    tc::mbar_init(&bar[1], 1);
    tc::mbar_init_fence();
  }
  if constexpr (MODE == CONV2)
    for (int i = tid; i < cin; i += THREADS) cf[i] = __ldg(&a.coef[(long long)b * cin + i]);
  __syncthreads();
  auto issue = [&](int c) {  // chunk c's weights into B stage c % 2
    tc::mbar_arrive_expect_tx(&bar[c & 1], S::B);
    tc::bulk_copy(bsm + (c & 1) * S::B, wsrc + (long long)c * S::B, S::B, &bar[c & 1]);
  };
  if (tid == 0) {
    issue(0);
    if (chunks > 1) issue(1);
  }

  // A chunk's input patch, KC channels of PH x PW pixels, goes through registers: thread tid
  // stages pixel tid % PIXELS, channels [half * CPT, half * CPT + CPT) of the chunk, half =
  // tid / PIXELS (two threads a pixel where 128 threads cover the patch twice). Its loads are
  // one channel plane apart; its stores, the pixel's channels, are contiguous in shared memory.
  using In = typename std::conditional<MODE == CONV2, float, T>::type;
  constexpr int SPLIT = 2 * S::PIXELS <= THREADS ? 2 : 1, CPT = G::KC / SPLIT;
  const int px = tid % S::PIXELS, half = tid / S::PIXELS;
  const int yy = y0 - S::HALO + px / S::PW, xx = x0 - S::HALO + px % S::PW;
  const bool inside = half < SPLIT && yy >= 0 && yy < h && xx >= 0 && xx < w;
  const In* __restrict__ src = static_cast<const In*>(a.in) + b * a.in_bstride +
                               (inside ? (long long)half * CPT * plane + (long long)yy * w + xx : 0);
  float pre[CPT];
  auto load_patch = [&](int c) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int ci = c * G::KC + half * CPT + j;
      pre[j] = inside && ci < cin ? gn::to_float(src[(long long)(c * G::KC + j) * plane]) : 0.f;
    }
  };
  auto store_patch = [&](int c, unsigned char* dst) {
    if (half >= SPLIT) return;
    uint32_t packed[CPT * sizeof(T) / 4];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float v = pre[j];
      if constexpr (MODE == CONV2) {  // GN1's affine with FiLM, and SiLU; the padding stays 0
        const int ci = c * G::KC + half * CPT + j;
        if (inside && ci < cin) v = gn::silu_affine(v, cf[ci]);
      }
      if constexpr (BF16) {
        const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
        packed[j / 2] = j % 2 ? packed[j / 2] | bits << 16 : bits;
      } else {
        packed[j] = __float_as_uint(v);
      }
    }
    uint4* row = reinterpret_cast<uint4*>(dst + px * S::PIX + half * CPT * (int)sizeof(T));
#pragma unroll
    for (int q = 0; q < CPT * (int)sizeof(T) / 16; ++q)
      row[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2], packed[4 * q + 3]);
  };

  // ldmatrix row of this lane: pixel 16 wwarp + lane % 16 of its warpgroup's tile, channel half
  // lane / 16
  const int m = 16 * wwarp + (lane & 15);
  const uint32_t lane_off = ((m / TW + TH * wg) * S::PW + m % TW) * S::PIX + 16 * (lane >> 4);

  load_patch(0);
  store_patch(0, patch);
  __syncthreads();

  // acc: the products of one chunk (fp32) or of all (bf16); sum: fp32's running sum of the
  // chunks' partials, added on the CUDA cores (the tensor cores truncate as they accumulate: a
  // 6912-deep fp32 sum kept in acc missed the 2e-5 gate)
  float acc[32], sum[BF16 ? 1 : 32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BF16 ? 1 : 32); ++i) sum[i] = 0.f;
  uint32_t fa[2][8];  // A fragments of a tap, double-buffered across taps
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    if (c + 1 < chunks) load_patch(c + 1);
    tc::mbar_wait(&bar[s], (c >> 1) & 1);
    const uint32_t a_base = tc::smem_addr(patch + s * S::A) + lane_off;
    const uint32_t b_base = tc::smem_addr(bsm + s * S::B);
    tc::fence_operand(acc);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      uint32_t(&f)[8] = fa[tap & 1];
      const uint32_t a_tap = a_base + ((tap / S::R) * S::PW + tap % S::R) * S::PIX;
      if constexpr (BF16) {
#pragma unroll
        for (int ks = 0; ks < G::KSTEPS; ++ks) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, a_tap + 32 * ks);
#pragma unroll
          for (int i = 0; i < 4; ++i) f[4 * ks + i] = r[i];
        }
      } else {
        uint32_t r0[4];
        tc::ldmatrix_x4(r0, a_tap);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const tc::Split sp = tc::split(__uint_as_float(r0[i]));
          f[i] = sp.hi;
          f[4 + i] = sp.lo;
        }
      }
      tc::wgmma_fence();
      if constexpr (BF16) {
#pragma unroll
        for (int ks = 0; ks < G::KSTEPS; ++ks)
          tc::wgmma_bf16(acc, f[4 * ks], f[4 * ks + 1], f[4 * ks + 2], f[4 * ks + 3],
                         tc::desc_k_major(b_base + (tap * G::KSTEPS + ks) * KSTEP_BYTES));
      } else {  // lo*hi + hi*lo + hi*hi, the small terms first
        const uint64_t dh = tc::desc_k_major(b_base + tap * KSTEP_BYTES);
        const uint64_t dl = tc::desc_k_major(b_base + (TAPS + tap) * KSTEP_BYTES);
        tc::wgmma_tf32(acc, f[4], f[5], f[6], f[7], dh);
        tc::wgmma_tf32(acc, f[0], f[1], f[2], f[3], dl);
        tc::wgmma_tf32(acc, f[0], f[1], f[2], f[3], dh);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the previous tap's products are done: its registers are free
      if (tap > 0) tc::fence_operand(fa[(tap + 1) & 1]);
    }
    tc::wgmma_wait<0>();  // this chunk's products are done: B stage s is free
    tc::fence_operand(acc);
    tc::fence_operand(fa[(TAPS - 1) & 1]);
    if constexpr (!BF16) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sum[i] += acc[i];
        acc[i] = 0.f;
      }
    }
    if (c + 1 < chunks) store_patch(c + 1, patch + (s ^ 1) * S::A);
    __syncthreads();
    if (tid == 0 && c + 2 < chunks) issue(c + 2);
  }

  // epilogue: accumulator rows g and g + 8 of warp wwarp of warpgroup wg are pixels
  // (y0 + 8 wg + 2 wwarp (+ 1), x0 + g); acc[4j + 2hh + e] is channel co0 + 8j + 2t + e
  const int x = x0 + g;
  float s1[16], s2[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * t + e;
      s1[2 * j + e] = s2[2 * j + e] = 0.f;
      if (co >= cout) continue;
      const float bias = __ldg(&a.bias[co]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int y = y0 + TH * wg + 2 * wwarp + hh;
        if (y >= h || x >= w) continue;
        const long long off = ((long long)b * cout + co) * plane + (long long)y * w + x;
        const float v = (BF16 ? acc[4 * j + 2 * hh + e] : sum[BF16 ? 0 : 4 * j + 2 * hh + e]) + bias;
        if constexpr (MODE == RESIDUAL) {
          const float gv = gn::silu_affine(__ldg(&a.h2[off]), __ldg(&a.coef[(long long)b * cout + co]));
          static_cast<T*>(a.out)[off] = gn::from_float<T>(gv + v);
        } else {
          a.out_f[off] = v;
          s1[2 * j + e] += v;
          s2[2 * j + e] = fmaf(v, v, s2[2 * j + e]);
        }
      }
    }
  if constexpr (MODE != RESIDUAL) {
    // a channel's 16 pixels of this warp lie on the 8 lanes of one t: sum them, then the 4
    // warps of the warpgroup, in a fixed order
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[i] += __shfl_xor_sync(FULL, s1[i], o);
        s2[i] += __shfl_xor_sync(FULL, s2[i], o);
      }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* r = red + 2 * (warp * BN + 8 * j + 2 * t + e);  // warp = 4 wg + wwarp
          r[0] = s1[2 * j + e];
          r[1] = s2[2 * j + e];
        }
    __syncthreads();
    const int ch = tid % BN, tg = tid / BN, ty = TY * by + tg;  // (channel, tile) of a writer
    if (tid < TY * BN && co0 + ch < cout && ty * TH < h) {
      float ss = 0.f, qq = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        ss += red[2 * ((4 * tg + w4) * BN + ch)];
        qq += red[2 * ((4 * tg + w4) * BN + ch) + 1];
      }
      const long long at = ((long long)b * cout + co0 + ch) * a.tiles + ty * a.tiles_x + tx;
      a.sums[at] = ss;
      a.sqs[at] = qq;
    }
  }
}

// The residual 1x1 conv with conv_tc's RESIDUAL epilogue, as a plain GEMM over runs of pixels:
// M = 64 consecutive pixels of the plane a warpgroup (RWG warpgroups a block), N = 64 output
// channels, K = Cin. A 1x1 conv reads no halo and no shifted window, so x's channel rows come
// straight into shared memory by bulk async copies, [channel][pixel], a chunk of KC channels a
// stage, RSTAGES chunks ahead, on the same mbarrier as the chunk's weights; A's fragments are
// read from there by transposed ldmatrix (bf16) or value by value (TF32). Where it runs:
// use_res_tc.
constexpr int RWG = 2, RSTAGES = 4, RM = 64 * RWG, RLD = RM + 8;  // RLD: conflict-free rows

template <typename T>
struct ResSmem {
  using G = Geo<T>;
  static constexpr int B = G::PLANES * G::KSTEPS * KSTEP_BYTES;      // a stage of weights
  static constexpr int A = align128(G::KC * RLD * (int)sizeof(T));  // a stage of x
  static constexpr int BYTES = RSTAGES * (B + A) + 8 * RSTAGES;
};

template <typename T>
__global__ void __launch_bounds__(WG_THREADS * RWG, 2) res_tc(ConvArgs a) {
  using G = Geo<T>;
  using S = ResSmem<T>;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bsm = smem;                                     // [RSTAGES][B]
  unsigned char* xsm = smem + RSTAGES * S::B;                    // [RSTAGES][A]: [KC][RLD] of T
  uint64_t* bar = reinterpret_cast<uint64_t*>(xsm + RSTAGES * S::A);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.z, co0 = blockIdx.y * BN, cout = a.cout, chunks = a.cin / G::KC;
  const long long plane = (long long)a.h * a.w, p0 = (long long)blockIdx.x * RM;
  const T* x = static_cast<const T*>(a.in) + b * a.in_bstride + p0;
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(a.wt) + (long long)blockIdx.y * chunks * S::B;

  auto issue = [&](int c) {  // by warp 0: chunk c's weights and KC rows of x into its stage
    const int st = c % RSTAGES;
    if (lane == 0) {
      tc::mbar_arrive_expect_tx(&bar[st], S::B + G::KC * RM * (int)sizeof(T));
      tc::bulk_copy(bsm + st * S::B, wsrc + (long long)c * S::B, S::B, &bar[st]);
    }
    __syncwarp();
    for (int r = lane; r < G::KC; r += 32)
      tc::bulk_copy(xsm + st * S::A + r * RLD * (int)sizeof(T), x + (long long)(c * G::KC + r) * plane,
                    RM * (int)sizeof(T), &bar[st]);
  };
  if (tid == 0) {
    for (int i = 0; i < RSTAGES; ++i) tc::mbar_init(&bar[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0)
    for (int c = 0; c < RSTAGES && c < chunks; ++c) issue(c);

  // this warp's 16 rows of A are pixels pw .. pw + 15 of the block's run
  const int pw = 64 * (warp / 4) + 16 * (warp % 4);
  float acc[32], sum[BF16 ? 1 : 32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BF16 ? 1 : 32); ++i) sum[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % RSTAGES;
    tc::mbar_wait(&bar[st], (c / RSTAGES) & 1);
    const unsigned char* xs = xsm + st * S::A;
    const uint32_t b_base = tc::smem_addr(bsm + st * S::B);
    uint32_t f[8];
    if constexpr (BF16) {
      // matrix q = lane / 8 of a k-step: channels 8 (q / 2) .., pixels pw + 8 (q % 2) ..
      const uint32_t a_base = tc::smem_addr(xs) +
                              2 * ((8 * (lane / 16) + lane % 8) * RLD + pw + 8 * ((lane / 8) % 2));
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, a_base + 2 * 16 * ks * RLD);
#pragma unroll
        for (int i = 0; i < 4; ++i) f[4 * ks + i] = r[i];
      }
    } else {
      const float* xf = reinterpret_cast<const float*>(xs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const tc::Split sp = tc::split(xf[(t + 4 * (i / 2)) * RLD + pw + g + 8 * (i % 2)]);
        f[i] = sp.hi;
        f[4 + i] = sp.lo;
      }
    }
    tc::fence_operand(acc);
    tc::wgmma_fence();
    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < G::KSTEPS; ++ks)
        tc::wgmma_bf16(acc, f[4 * ks], f[4 * ks + 1], f[4 * ks + 2], f[4 * ks + 3],
                       tc::desc_k_major(b_base + ks * KSTEP_BYTES));
    } else {  // lo*hi + hi*lo + hi*hi, the small terms first
      const uint64_t dh = tc::desc_k_major(b_base), dl = tc::desc_k_major(b_base + KSTEP_BYTES);
      tc::wgmma_tf32(acc, f[4], f[5], f[6], f[7], dh);
      tc::wgmma_tf32(acc, f[0], f[1], f[2], f[3], dl);
      tc::wgmma_tf32(acc, f[0], f[1], f[2], f[3], dh);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_operand(acc);
    tc::fence_operand(f);
    if constexpr (!BF16) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sum[i] += acc[i];
        acc[i] = 0.f;
      }
    }
    __syncthreads();  // every warp has read stage st
    if (warp == 0 && c + RSTAGES < chunks) issue(c + RSTAGES);
  }

  // epilogue: accumulator rows g and g + 8 are pixels pw + g (+ 8); acc[4j + 2hh + e] is channel
  // co0 + 8j + 2t + e
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * t + e;
      if (co >= cout) continue;
      const float bias = __ldg(&a.bias[co]);
      const float2 ab = __ldg(&a.coef[(long long)b * cout + co]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long off = ((long long)b * cout + co) * plane + p0 + pw + g + 8 * hh;
        const float v = (BF16 ? acc[4 * j + 2 * hh + e] : sum[BF16 ? 0 : 4 * j + 2 * hh + e]) + bias;
        static_cast<T*>(a.out)[off] = gn::from_float<T>(gn::silu_affine(__ldg(&a.h2[off]), ab) + v);
      }
    }
}

// Per (batch, group): the group's statistics from the partials, then the affine of every
// channel of the group with its FiLM scale and shift (none when scale and shift are null).
// The group's (mean, rstd) also go to stats (B, groups), for the backward (resblock_backward.cu).
template <typename TF>
__global__ void __launch_bounds__(256)
gn_coefs(const float* __restrict__ sums, const float* __restrict__ sqs, int c, int groups,
         int tiles, float count, float eps, const float* __restrict__ gamma,
         const float* __restrict__ beta, const TF* __restrict__ scale,
         const TF* __restrict__ shift, long long film_stride, float2* __restrict__ coef,
         float2* __restrict__ group_stats) {
  __shared__ float red[32];
  const int g = blockIdx.x, b = blockIdx.y, cg = c / groups;
  const float2 stats = gn::group_stats(sums, sqs, b, g, c, groups, tiles, count, eps, red);
  if (threadIdx.x == 0) group_stats[b * groups + g] = stats;
  for (int i = threadIdx.x; i < cg; i += blockDim.x) {
    const int ch = g * cg + i;
    const long long film = (long long)b * film_stride + ch;
    coef[(long long)b * c + ch] =
        gn::film_affine(stats, gamma[ch], beta[ch], scale ? gn::to_float(scale[film]) : 0.f,
                        shift ? gn::to_float(shift[film]) : 0.f);
  }
}

// out = T(SiLU(GN2(h2)) + x), the identity residual (Cin == Cout); 4 elements a thread, with
// vector loads and stores where the plane and x's rows allow them.
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
finish_identity(const float* __restrict__ h2, const float2* __restrict__ coef,
                const T* __restrict__ x, long long x_bstride, int c, long long plane,
                T* __restrict__ out) {
  using Vec = typename std::conditional<std::is_same<T, bf16>::value, uint2, uint4>::type;
  const int bc = blockIdx.y;
  const long long i0 = 4 * ((long long)blockIdx.x * EW_THREADS + threadIdx.x);
  if (i0 >= plane) return;
  const float2 ab = __ldg(&coef[bc]);
  const long long off = (long long)bc * plane + i0;
  const T* xr = x + (bc / c) * x_bstride + (bc % c) * plane + i0;
  if (plane % 4 == 0 && reinterpret_cast<uintptr_t>(xr) % sizeof(Vec) == 0) {
    const float4 hv = *reinterpret_cast<const float4*>(h2 + off);
    Vec xv = *reinterpret_cast<const Vec*>(xr);
    T* xe = reinterpret_cast<T*>(&xv);
    const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) xe[k] = gn::from_float<T>(gn::silu_affine(hs[k], ab) + gn::to_float(xe[k]));
    *reinterpret_cast<Vec*>(out + off) = xv;
    return;
  }
  for (int k = 0; k < 4 && i0 + k < plane; ++k)
    out[off + k] = gn::from_float<T>(gn::silu_affine(h2[off + k], ab) + gn::to_float(xr[k]));
}

int tiles_of(int h, int w) { return ((h + TH - 1) / TH) * ((w + TW - 1) / TW); }

template <typename T, int TAPS, int MODE, int TY>
cudaError_t launch_conv_ty(const ConvArgs& a, int batch, cudaStream_t s) {
  using S = Smem<T, TAPS, TY>;
  const int bytes = S::BYTES + (MODE == CONV2 ? 8 * a.cin : 0);
  cudaError_t err = cudaFuncSetAttribute(conv_tc<T, TAPS, MODE, TY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles_y = (a.h + TH - 1) / TH;
  const dim3 grid(((tiles_y + TY - 1) / TY) * a.tiles_x, (a.cout + BN - 1) / BN, batch);
  conv_tc<T, TAPS, MODE, TY><<<grid, S::THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

// Two warpgroups a block share each chunk of weights, which halves the weights' traffic from L2
// (at 16^2 with 512 channels the single-tile blocks ran at the L2's rate); where that leaves too
// few blocks to fill the card, one warpgroup a block.
template <typename T, int TAPS, int MODE>
cudaError_t launch_conv(const ConvArgs& a, int batch, cudaStream_t s) {
  constexpr int MIN_BLOCKS = 100;
  const long long pairs = (long long)(((a.h + TH - 1) / TH + 1) / 2) * a.tiles_x *
                          ((a.cout + BN - 1) / BN) * batch;
  if (pairs >= MIN_BLOCKS) return launch_conv_ty<T, TAPS, MODE, 2>(a, batch, s);
  return launch_conv_ty<T, TAPS, MODE, 1>(a, batch, s);
}

// whether a's residual conv goes to res_tc. It can run it on whole runs of RM pixels, whole
// chunks of channels and 16-byte aligned rows of x. It is the faster kernel at every residual
// call shape of the UNet in bf16 (1.13-1.96x), but in fp32 only from 64^2 pixels up: at 16^2 and
// 32^2 conv_tc<RESIDUAL> is as fast or faster (chip_smoke.py residual_routes times both, PERF.md).
constexpr long long RES_TC_MIN_PLANE_FP32 = 64 * 64;

template <typename T>
bool use_res_tc(const ConvArgs& a) {
  const long long plane = (long long)a.h * a.w;
  if (!std::is_same<T, bf16>::value && plane < RES_TC_MIN_PLANE_FP32) return false;
  return plane % RM == 0 && a.cin % Geo<T>::KC == 0 && reinterpret_cast<uintptr_t>(a.in) % 16 == 0 &&
         (a.in_bstride * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
cudaError_t launch_res(const ConvArgs& a, int batch, cudaStream_t s) {
  constexpr int bytes = ResSmem<T>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(res_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long long)a.h * a.w / RM), (a.cout + BN - 1) / BN, batch);
  res_tc<T><<<grid, WG_THREADS * RWG, bytes, s>>>(a);
  return cudaGetLastError();
}

#define RETURN_IF_FAILED(expr)                 \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T, typename TF>
int launch(const void* x, long long x_bstride, int batch, int cin, int cout, int h, int w,
           const void* w1t, const float* b1, const float* g1, const float* be1,
           const void* scale, const void* shift, long long film_stride, const void* w2t,
           const float* b2, const float* g2, const float* be2, const void* wrest,
           const float* bres, int groups, float eps, float* saved, float* scratch, void* out,
           cudaStream_t s) {
  const int tiles = tiles_of(h, w);
  const long long plane = (long long)h * w, act = (long long)batch * cout * plane;
  const long long part = (long long)batch * cout * tiles;
  float2* coef1 = reinterpret_cast<float2*>(saved);  // the layout of rb_saved_floats
  float2* coef2 = coef1 + (long long)batch * cout;
  float2* stats1 = coef2 + (long long)batch * cout;
  float2* stats2 = stats1 + (long long)batch * groups;
  float* h1 = saved + 4LL * batch * cout + 4LL * batch * groups;
  float* h2 = h1 + act;
  float* sums1 = scratch;
  float* sqs1 = sums1 + part;
  float* sums2 = sqs1 + part;
  float* sqs2 = sums2 + part;
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
  RETURN_IF_FAILED((launch_conv<T, 9, CONV1>(a, batch, s)));
  gn_coefs<TF><<<dim3(groups, batch), 256, 0, s>>>(  // (b) GN1 with FiLM
      sums1, sqs1, cout, groups, tiles, count, eps, g1, be1, static_cast<const TF*>(scale),
      static_cast<const TF*>(shift), film_stride, coef1, stats1);
  RETURN_IF_FAILED(cudaGetLastError());

  a.in = h1;  // (c) conv2 over GN1+SiLU(h1)
  a.in_bstride = cout * plane;
  a.cin = cout;
  a.wt = w2t;
  a.bias = b2;
  a.coef = coef1;
  a.out_f = h2;
  a.sums = sums2;
  a.sqs = sqs2;
  RETURN_IF_FAILED((launch_conv<T, 9, CONV2>(a, batch, s)));
  gn_coefs<float><<<dim3(groups, batch), 256, 0, s>>>(  // (d) GN2
      sums2, sqs2, cout, groups, tiles, count, eps, g2, be2, nullptr, nullptr, 0, coef2, stats2);
  RETURN_IF_FAILED(cudaGetLastError());

  if (wrest == nullptr) {  // (e) the residual
    const long long per_block = 4LL * EW_THREADS;
    finish_identity<T><<<dim3((unsigned)((plane + per_block - 1) / per_block), batch * cout),
                         EW_THREADS, 0, s>>>(h2, coef2, static_cast<const T*>(x), x_bstride,
                                             cout, plane, static_cast<T*>(out));
    return (int)cudaGetLastError();
  }
  a.in = x;
  a.in_bstride = x_bstride;
  a.cin = cin;
  a.wt = wrest;
  a.bias = bres;
  a.coef = coef2;
  a.h2 = h2;
  a.out = out;
  if (use_res_tc<T>(a)) return (int)launch_res<T>(a, batch, s);
  return (int)launch_conv<T, 1, RESIDUAL>(a, batch, s);
}

}  // namespace

extern "C" {

// Floats of what rb_forward leaves for the backward, in this order: GN1's and GN2's affines
// (B, Cout) and group statistics (mean, rstd) (B, groups), all float2, then h1 and h2 (B, Cout,
// H, W) fp32, each 16-byte aligned.
long long rb_saved_floats(int batch, int cout, int h, int w, int groups) {
  const long long bc = (long long)batch * cout;
  return 4 * bc + 4LL * batch * groups + 2 * bc * h * w;
}

// Floats of scratch that rb_forward needs besides: the GroupNorm partials.
long long rb_scratch_floats(int batch, int cout, int h, int w) {
  return 4LL * batch * cout * tiles_of(h, w);
}

// Launches the block's passes on `stream`; returns the first CUDA error, else 0. x_bf16 says
// whether x and out are bf16 (else fp32); film_bf16 whether scale and shift are bf16 (else
// fp32; only with bf16 x); they may be null (no FiLM), and row b of each starts at
// b * film_stride. w1t, w2t and wrest are the weights in the tensor-core layout of x's dtype
// (kernels/resblock.py, tc_weight_layout); wrest and bres are null for the identity residual
// (Cin == Cout). Biases, gains and shifts are fp32 (Cout,). Cout is a multiple of 4 and of
// groups. out is contiguous (B, Cout, H, W) in x's dtype. saved and scratch (16-byte aligned)
// hold rb_saved_floats and rb_scratch_floats.
int rb_forward(int x_bf16, int film_bf16, const void* x, long long x_bstride, int batch, int cin,
               int cout, int h, int w, const void* w1t, const float* b1, const float* g1,
               const float* be1, const void* scale, const void* shift, long long film_stride,
               const void* w2t, const float* b2, const float* g2, const float* be2,
               const void* wrest, const float* bres, int groups, float eps, float* saved,
               float* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return launch<float, float>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                                shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                                saved, scratch, out, s);
  if (film_bf16)
    return launch<bf16, bf16>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                              shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                              saved, scratch, out, s);
  return launch<bf16, float>(x, x_bstride, batch, cin, cout, h, w, w1t, b1, g1, be1, scale,
                             shift, film_stride, w2t, b2, g2, be2, wrest, bres, groups, eps,
                             saved, scratch, out, s);
}

}  // extern "C"
