// Flash cosine attention, fp32 or bf16 inputs, fp32 results, on Hopper's tensor cores (sm_90a).
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
// 0.27 GFLOP, run here as three TF32 products each (1.6 us at 495 TFLOP/s); in bf16 2 MB (0.6
// us) and two bf16 products each (0.5 us at 989 TFLOP/s). The latency of one launch of 128
// blocks dominates. At N = 4096 (512^2 inputs) the products take over, 64 GFLOP a call.
//
// Design. The TPU kernel holds one (batch*head) row in VMEM and computes its norms there before
// its q tiles. Here a block takes 64 queries of one (batch, head) in 8 warps: 4 query warps of
// 16 queries, times 2 key groups that walk alternate key tiles of 64, each with its own running
// max, sum and output, merged at the end (one launch at N = 256 is only 4 tiles; two groups
// halve each warp's serial chain and give an SM 8 warps). Two kernels share that compute:
//   - flash_row, for N <= 256 (the path's N: one launch a call). Each block loads the whole q,
//     k and v rows of its (batch, head) at once, 16 bytes a load, sums the squares of q and k
//     from the registers those loads filled (the norms), and stages k and v whole in shared
//     memory (33 KiB in bf16, 132 KiB as fp32's TF32 planes); then no load waits inside the key
//     loop and no barrier but two.
//   - flash_fwd, above N = 256: each key group stages its tiles in turn, the next tile's loads
//     issued before the current tile's products. The norms come from a pre-pass, row_norms:
//     re-read instead by each of the N / 64 blocks of a (batch, head), they cost more than the
//     extra launch (fp32 0.1172 against 0.1099 ms at N = 1024 and 1.6263 against 1.4706 ms at
//     N = 4096 on an H100, chip_smoke.py, PERF.md), so the pre-pass stays.
//   - The norms' 1 / (|q_d| |k_d|), with scale * log2(e), are folded into q: the softmax is exp2.
//   - Products on the tensor cores (mma.sync) to fp32 accuracy, as the JAX kernel runs its
//     products at Precision.HIGHEST: one TF32 product reads 1.2e-4 of output error against the
//     2e-5 fp32 gate (CPU emulation, tests/test_torch_flash_attention.py). fp32 inputs: m16n8k8
//     TF32 with split operands, a = hi + lo, a b = lo*hi + hi*lo + hi*hi. bf16 inputs: k and v
//     are exact in bf16, so only the folded q and the probabilities are split, into two bf16
//     parts (hi + lo, 2^-16 of |a|), and each product is two m16n8k16 bf16 products: a quarter
//     of the tensor-core cycles of split TF32's two m16n8k8 TF32 products, for a result that
//     keeps the fp32 plain version's value to 1.6e-6 before the output's rounding (the CPU
//     emulation).
//   - S = q^T k for 16 queries x 64 keys lands in the accumulator layout, a row over the 4
//     lanes of a quad: the running max takes two quad shuffles; the running sum stays per lane
//     and is summed once at the end. Keys past N score -inf, so exp2 gives them 0, and their k
//     and v are staged as 0. P feeds P v straight from the accumulator registers: in bf16 two
//     accumulator blocks of S are the A layout of a k16 step; in TF32 the k index of the second
//     product is permuted (k = t <-> key 2t, k = t + 4 <-> key 2t + 1) so that one block is.
//   - Staged rows are padded by 8 values or words (conflict-free fragment reads). fp32 k and v
//     are split into TF32 hi and lo planes once, when staged; bf16 k and v are staged as loaded
//     and read by ldmatrix (k transposed: the B operand of S is k by d).
// q, k and v may each have any batch stride; within a batch element they are contiguous (head
// stride d*N, row stride N), so the three chunks of the qkv conv's output go in without a copy.
// out is contiguous.

#include <type_traits>

#include "group_norm.cuh"
#include "tensor_core.cuh"

namespace {

using gn::bf16;

constexpr int D = 32;                        // dim_head
constexpr int QW = 4;                        // query warps: 16 queries each
constexpr int GROUP = 32 * QW;               // threads of a key group
constexpr int BQ = 16 * QW;                  // queries per block
constexpr int BK = 64;                       // keys per staged tile
constexpr int LDT = BK + 8;                  // row stride of a staged tile: words or bf16 values
constexpr int NORM_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

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

// barrier over the GROUP threads of key group grp (named barrier 1 + grp; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(GROUP) : "memory");
}

// The compute of a block, shared by both kernels below. A block takes BQ = 64 queries of one
// (batch, head) in 8 warps: 4 query warps of 16 queries times KG = 2 key groups, each walking
// every other key tile of BK = 64 keys with its own running max, sum and output, merged at the
// end. (One launch at N = 256 is 4 tiles: two groups halve each warp's serial chain and give an
// SM 8 warps. Four groups, 512 threads at 128 registers each, spilled and ran slower.)
constexpr int KG = 2;
constexpr int THREADS = 32 * QW * KG;
constexpr int MERGE = GROUP * 20;  // a key group's (m0, m1, l0, l1, o[16]), [20][GROUP] floats

// A staged tile of k or v, row stride ld: bf16 values as loaded, [D][ld], the operands of the
// bf16 products; or for fp32 the TF32 hi and lo planes, [2][D][ld] words.
template <typename T>
struct Staged {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  static __host__ __device__ constexpr int words(int ld) { return BF16 ? D * ld / 2 : 2 * D * ld; }
};

// stores 16 bytes of k or v (VEC consecutive keys j.. of row d) into a staged tile
template <typename T>
__device__ __forceinline__ void stage16(uint32_t* tile, int ld, int d, int j, const uint4& raw) {
  if constexpr (Staged<T>::BF16) {
    *reinterpret_cast<uint4*>(&tile[(d * ld + j) / 2]) = raw;
  } else {  // split once into the TF32 hi and lo planes
    const float* e = reinterpret_cast<const float*>(&raw);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const tc::Split sp = tc::split(e[x]);
      hi[x] = sp.hi, lo[x] = sp.lo;
    }
    *reinterpret_cast<uint4*>(&tile[d * ld + j]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(&tile[D * ld + d * ld + j]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A warp's 16 queries as A fragments over d, 16 values a thread, and the online-softmax state
// of its rows g and g + 8 (g = lane / 4, t = lane % 4). For TF32 (m16n8k8) value 4 kk + i is
// (row g + 8 (i % 2), d 8 kk + t + 4 (i / 2)); for bf16 (m16n8k16) values 4 kk + i and
// 8 + 4 kk + i are the pair (row g + 8 (i % 2), d 16 kk + 2 t + 8 (i / 2) and d + 1).
template <typename T>
struct Queries {
  uint32_t hi[4][4], lo[4][4];  // split: TF32 hi and lo, or bf16 hi and lo pairs
  float o[4][4] = {};           // out^T: rows g, g + 8; dims 8 dj + 2 t, + 1
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's share of the sums

  static __device__ __forceinline__ int dim(int x, int t) {
    const int i = x % 4;
    return Staged<T>::BF16 ? 16 * ((x / 4) % 2) + 2 * t + 8 * (i / 2) + x / 8
                           : 8 * (x / 4) + t + 4 * (i / 2);
  }
  // the raw values of columns q0 + g (+ 8) of the (D, n) row qb, 0 past n
  static __device__ __forceinline__ void load(float (&qr)[16], const T* qb, int n, int q0, int lane) {
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int col = q0 + lane / 4 + 8 * (x % 2);
      qr[x] = col < n ? gn::to_float(qb[(long long)dim(x, lane % 4) * n + col]) : 0.f;
    }
  }
  // folds scale log2(e) / (|q_d| |k_d|), fx[x] for value x, into the raw values and splits them
  __device__ __forceinline__ void fold(const float (&qr)[16], const float (&fx)[16]) {
    if constexpr (Staged<T>::BF16) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const tc::Split sp = tc::split_bf16x2(qr[x] * fx[x], qr[x + 8] * fx[x + 8]);
        hi[x / 4][x % 4] = sp.hi;
        lo[x / 4][x % 4] = sp.lo;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const tc::Split sp = tc::split(qr[x] * fx[x]);
        hi[x / 4][x % 4] = sp.hi;
        lo[x / 4][x % 4] = sp.lo;
      }
    }
  }

  // one tile of keys base .. base + 63 staged at ks, vs (row stride ld): the scores, the online
  // softmax, o += P v
  __device__ __forceinline__ void tile(const uint32_t* ks, const uint32_t* vs, int ld, int base,
                                       int n, int lane) {
    const int g = lane / 4, t = lane % 4;
    // S over the tile: the 8 key blocks' products side by side, the small terms first
    float s[8][4] = {};
    if constexpr (Staged<T>::BF16) {
      // k as B (k = d, n = key) by transposed loads of its [d][key] tile: matrix m is d 8m..
      const uint32_t kaddr = tc::smem_addr(ks) + 2 * ((lane % 8 + 8 * (lane / 8)) * ld);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t kf[4];
        tc::ldmatrix_x4_trans(kf, kaddr + 2 * 8 * j);
        tc::mma_bf16(s[j], lo[0], kf[0], kf[1]);
        tc::mma_bf16(s[j], lo[1], kf[2], kf[3]);
        tc::mma_bf16(s[j], hi[0], kf[0], kf[1]);
        tc::mma_bf16(s[j], hi[1], kf[2], kf[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int at = (8 * kk + t) * ld + 8 * j + g;
          bh[j][0] = ks[at];
          bh[j][1] = ks[at + 4 * ld];
          bl[j][0] = ks[D * ld + at];
          bl[j][1] = ks[D * ld + at + 4 * ld];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tc::mma_tf32(s[j], lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tc::mma_tf32(s[j], hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3], bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tc::mma_tf32(s[j], hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3], bh[j][0], bh[j][1]);
      }
    }
    if (base + BK > n)  // the last tile, ragged
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (base + 8 * j + 2 * t + (i & 1) >= n) s[j][i] = -INFINITY;  // exp2(-inf) = 0
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);  // finite: key `base` is valid
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);   // 0 on the first tile
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - n0);
      s[j][1] = exp2f(s[j][1] - n0);
      s[j][2] = exp2f(s[j][2] - n1);
      s[j][3] = exp2f(s[j][3] - n1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    if constexpr (Staged<T>::BF16) {
      // o += P v, 16 keys a k-step: S's accumulator blocks 2 kk and 2 kk + 1 are the A layout;
      // v as B (k = key, n = d) straight from its [d][key] tile: matrix m is d block
      // 2 dp + m / 2, keys + 8 (m % 2)
      const uint32_t vaddr =
          tc::smem_addr(vs) + 2 * ((lane % 8 + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const tc::Split p0 = tc::split_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        const tc::Split p1 = tc::split_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        const tc::Split p2 = tc::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const tc::Split p3 = tc::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const uint32_t ph[4] = {p0.hi, p1.hi, p2.hi, p3.hi}, pl[4] = {p0.lo, p1.lo, p2.lo, p3.lo};
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t vf[4];
          tc::ldmatrix_x4(vf, vaddr + 2 * (16 * dp * ld + 16 * kk));
          tc::mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
          tc::mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
          tc::mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
          tc::mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        }
      }
    } else {
      // o += P v over the tile, 8 keys (one accumulator block of S) a k-step: the k index is
      // permuted (k = t <-> key 2t, k = t + 4 <-> key 2t + 1) so that S's accumulator layout
      // is the A layout
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const tc::Split p0 = tc::split(s[j][0]), p1 = tc::split(s[j][2]);
        const tc::Split p2 = tc::split(s[j][1]), p3 = tc::split(s[j][3]);
        uint2 vh[4], vl[4];
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) {
          const int at = (8 * dj + g) * ld + 8 * j + 2 * t;
          vh[dj] = *reinterpret_cast<const uint2*>(&vs[at]);
          vl[dj] = *reinterpret_cast<const uint2*>(&vs[D * ld + at]);
        }
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) tc::mma_tf32(o[dj], p0.lo, p1.lo, p2.lo, p3.lo, vh[dj].x, vh[dj].y);
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) tc::mma_tf32(o[dj], p0.hi, p1.hi, p2.hi, p3.hi, vl[dj].x, vl[dj].y);
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) tc::mma_tf32(o[dj], p0.hi, p1.hi, p2.hi, p3.hi, vh[dj].x, vh[dj].y);
      }
    }
  }

  // merges the key groups' states into group 0 (the same lane of the same query warp holds the
  // same rows and dims in every group) through `merge` ([KG - 1][MERGE] floats), which group 0
  // writes out: columns q0 + g (+ 8) of the (D, n) output row ob. All threads of the block call.
  __device__ __forceinline__ void finish(float* merge, int grp, int gtid, T* ob, int n, int q0,
                                         int lane) {
    if (grp > 0) {
      float* my = merge + (grp - 1) * MERGE + gtid;  // value k at my[k * GROUP]
      my[0] = m0;
      my[GROUP] = m1;
      my[2 * GROUP] = l0;
      my[3 * GROUP] = l1;
#pragma unroll
      for (int dj = 0; dj < 4; ++dj)
#pragma unroll
        for (int i = 0; i < 4; ++i) my[(4 + 4 * dj + i) * GROUP] = o[dj][i];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int other = 1; other < KG; ++other) {
      const float* at = merge + (other - 1) * MERGE + gtid;
      float its[20];
#pragma unroll
      for (int k = 0; k < 20; ++k) its[k] = at[k * GROUP];
      const float n0 = fmaxf(m0, its[0]), n1 = fmaxf(m1, its[1]);  // finite: group 0 has tile 0
      const float a0 = exp2f(m0 - n0), b0 = exp2f(its[0] - n0);   // 0 for a group without tiles
      const float a1 = exp2f(m1 - n1), b1 = exp2f(its[1] - n1);
      m0 = n0;
      m1 = n1;
      l0 = l0 * a0 + its[2] * b0;
      l1 = l1 * a1 + its[3] * b1;
#pragma unroll
      for (int dj = 0; dj < 4; ++dj) {
        o[dj][0] = o[dj][0] * a0 + its[4 + 4 * dj] * b0;
        o[dj][1] = o[dj][1] * a0 + its[5 + 4 * dj] * b0;
        o[dj][2] = o[dj][2] * a1 + its[6 + 4 * dj] * b1;
        o[dj][3] = o[dj][3] * a1 + its[7 + 4 * dj] * b1;
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int g = lane / 4, t = lane % 4, c0 = q0 + g, c1 = q0 + g + 8;
#pragma unroll
    for (int dj = 0; dj < 4; ++dj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long row = (long long)(8 * dj + 2 * t + e) * n;
        if (c0 < n) ob[row + c0] = gn::from_float<T>(o[dj][e] * inv0);
        if (c1 < n) ob[row + c1] = gn::from_float<T>(o[dj][2 + e] * inv1);
      }
  }
};

// Whole rows: N <= ROW_N (the path's N = 256), one launch. Every block stages the whole k and v
// rows of its (batch, head) in shared memory with one round of 16-byte loads and reads q's
// whole row in the same round, summing the squares of q and k from the registers the loads
// filled: the norms cost no pass of their own. Shared memory: k, v staged with row stride
// ROW_LD, the merge area, the norm partials and the fold.
constexpr int ROW_N = 256;
constexpr int ROW_LD = ROW_N + 8;  // conflict-free fragment reads, as LDT
template <typename T>
struct RowSmem {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNKS = D * ROW_N / VEC;  // 16-byte chunks of a (D, ROW_N) row
  static constexpr int PARTS = ROW_N / VEC / 32;  // warps that share one of its rows
  static constexpr int PER_THREAD = CHUNKS / THREADS;
  static constexpr int TILE = Staged<T>::words(ROW_LD);
  static constexpr int QLD = BQ + 8;                           // the block's queries, [D][QLD]
  static constexpr int QUERIES = D * QLD * (int)sizeof(T) / 4;  // ... in words
  static constexpr int BYTES = 4 * (2 * TILE + QUERIES + (KG - 1) * MERGE + 2 * D * PARTS);
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_row(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          long long q_bstride, long long k_bstride, long long v_bstride, int heads, int n,
          float scale, T* __restrict__ out) {
  using R = RowSmem<T>;
  extern __shared__ __align__(16) uint32_t fsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qw = warp % QW, grp = warp / QW, gtid = tid % GROUP;
  uint32_t* ks = fsm;
  uint32_t* vs = ks + R::TILE;
  T* qsm = reinterpret_cast<T*>(vs + R::TILE);
  float* merge = reinterpret_cast<float*>(vs + R::TILE + R::QUERIES);
  float* part = merge + (KG - 1) * MERGE;  // [2 D][PARTS] sums of squares of q, k rows

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const long long head = (long long)h * D * n;
  const T* qb = q + b * q_bstride + head;
  const T* kb = k + b * k_bstride + head;
  const T* vb = v + b * v_bstride + head;

  // one round of loads: chunk tid + THREADS r of each row is (row d, keys VEC c ..), zeros past n;
  // a warp's 32 chunks are one part of one row
  const bool vec_ok = n % R::VEC == 0 && reinterpret_cast<uintptr_t>(qb) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vb) % 16 == 0;
  auto load = [&](const T* row, int j) {
    uint4 raw;
    if (vec_ok && j + R::VEC <= n) {
      raw = *reinterpret_cast<const uint4*>(row + j);
    } else {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int x = 0; x < R::VEC; ++x) e[x] = j + x < n ? row[j + x] : gn::from_float<T>(0.f);
    }
    return raw;
  };
  uint4 qc[R::PER_THREAD], kc[R::PER_THREAD], vc[R::PER_THREAD];
#pragma unroll
  for (int r = 0; r < R::PER_THREAD; ++r) {
    const int i = tid + THREADS * r, d = i / (ROW_N / R::VEC), j = (i % (ROW_N / R::VEC)) * R::VEC;
    const long long at = (long long)d * n;
    qc[r] = j < n ? load(qb + at, j) : make_uint4(0, 0, 0, 0);
    kc[r] = j < n ? load(kb + at, j) : make_uint4(0, 0, 0, 0);
    vc[r] = j < n ? load(vb + at, j) : make_uint4(0, 0, 0, 0);
  }

  // the squares summed, k and v staged, and the block's queries kept
#pragma unroll
  for (int r = 0; r < R::PER_THREAD; ++r) {
    const int i = tid + THREADS * r, d = i / (ROW_N / R::VEC), j = (i % (ROW_N / R::VEC)) * R::VEC;
    const T* qe = reinterpret_cast<const T*>(&qc[r]);
    const T* ke = reinterpret_cast<const T*>(&kc[r]);
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int x = 0; x < R::VEC; ++x) {
      const float a = gn::to_float(qe[x]), c = gn::to_float(ke[x]);
      sq = fmaf(a, a, sq);
      sk = fmaf(c, c, sk);
    }
    sq = gn::warp_sum(sq);
    sk = gn::warp_sum(sk);
    if (lane == 0) {
      const int p = (i % (ROW_N / R::VEC)) / 32;
      part[d * R::PARTS + p] = sq;
      part[(D + d) * R::PARTS + p] = sk;
    }
    stage16<T>(ks, ROW_LD, d, j, kc[r]);
    stage16<T>(vs, ROW_LD, d, j, vc[r]);
    const int col = j - blockIdx.x * BQ;
    if (col >= 0 && col < BQ) *reinterpret_cast<uint4*>(&qsm[d * R::QLD + col]) = qc[r];
  }
  __syncthreads();

  // lane d of every warp folds row d; shuffles hand each value its fold
  float f;
  {
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int p = 0; p < R::PARTS; ++p) {
      sq += part[lane * R::PARTS + p];
      sk += part[(D + lane) * R::PARTS + p];
    }
    f = scale * LOG2E / (fmaxf(sqrtf(sq), 1e-12f) * fmaxf(sqrtf(sk), 1e-12f));
  }
  const int q0 = blockIdx.x * BQ + 16 * qw, t = lane % 4;
  float qr[16], fx[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const int d = Queries<T>::dim(x, t);
    qr[x] = gn::to_float(qsm[d * R::QLD + 16 * qw + lane / 4 + 8 * (x % 2)]);
    fx[x] = __shfl_sync(0xffffffffu, f, d);
  }
  Queries<T> qs;
  qs.fold(qr, fx);
  const int tiles = (n + BK - 1) / BK;
  constexpr int COL = Staged<T>::BF16 ? BK / 2 : BK;  // words between tiles along a staged row
  for (int tile = grp; tile < tiles; tile += KG)
    qs.tile(ks + tile * COL, vs + tile * COL, ROW_LD, tile * BK, n, lane);
  qs.finish(merge, grp, gtid, out + (long long)bh * D * n, n, q0, lane);
}

// Tiles, above ROW_N (any N works). Each key group stages its tiles of k and v in turn (row stride LDT),
// loading the next into registers before the products of the current one. The norms come from
// the pre-pass (row_norms).
template <typename T>
struct TileSmem {
  static constexpr int TILE = Staged<T>::words(LDT);  // words of k (or v)
  static constexpr int BYTES = 4 * (KG * 2 * TILE + (KG - 1) * MERGE + 3 * D);
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          long long q_bstride, long long k_bstride, long long v_bstride, int heads, int n,
          const float* __restrict__ norms, float scale, T* __restrict__ out) {
  using S = TileSmem<T>;
  extern __shared__ __align__(16) uint32_t fsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qw = warp % QW, grp = warp / QW, gtid = tid % GROUP;
  uint32_t* ks = fsm + grp * 2 * S::TILE;  // this group's tile of k
  uint32_t* vs = ks + S::TILE;              // ... and of v
  float* merge = reinterpret_cast<float*>(fsm + KG * 2 * S::TILE);
  float* nrm = merge + (KG - 1) * MERGE;  // [2 D]
  float* fold = nrm + 2 * D;              // [D]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const long long head = (long long)h * D * n;
  const T* qb = q + b * q_bstride + head;
  const T* kb = k + b * k_bstride + head;
  const T* vb = v + b * v_bstride + head;
  const int tiles = (n + BK - 1) / BK;

  // this group's first key tile and this warp's 16 queries: their loads go out before anything
  // waits on memory. A thread stages VEC consecutive keys of a row at a time, with one 16-byte
  // load where N and the rows allow it, else value by value.
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SLOTS = D * BK / (GROUP * VEC);  // 16-byte slots of k (and of v) a thread, a tile
  const bool vec_ok = n % VEC == 0 && reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(vb) % 16 == 0;
  uint4 kq[SLOTS], vq[SLOTS];
  auto load_row = [&](uint4& dst, const T* row, int j) {
    if (vec_ok && j + VEC <= n) {
      dst = *reinterpret_cast<const uint4*>(row + j);
    } else {  // the ragged end, or rows off 16 bytes: zeros past N
      T* e = reinterpret_cast<T*>(&dst);
#pragma unroll
      for (int x = 0; x < VEC; ++x) e[x] = j + x < n ? row[j + x] : gn::from_float<T>(0.f);
    }
  };
  auto load_tile = [&](int base) {
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) {
      const int i = gtid + r * GROUP, d = i / (BK / VEC), j = base + (i % (BK / VEC)) * VEC;
      load_row(kq[r], kb + (long long)d * n, j);
      load_row(vq[r], vb + (long long)d * n, j);
    }
  };
  if (grp < tiles) load_tile(grp * BK);
  const int q0 = blockIdx.x * BQ + 16 * qw;
  float qr[16];
  Queries<T>::load(qr, qb, n, q0, lane);

  if (tid < 2 * D) {
    const int rows = gridDim.y * D;
    nrm[tid] = norms[(tid < D ? 0 : rows - D) + bh * D + tid];
  }
  __syncthreads();
  if (tid < D) fold[tid] = scale * LOG2E / (nrm[tid] * nrm[D + tid]);
  __syncthreads();

  Queries<T> qs;
  float fx[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) fx[x] = fold[Queries<T>::dim(x, lane % 4)];
  qs.fold(qr, fx);
  for (int tile = grp; tile < tiles; tile += KG) {
    const int base = tile * BK;
    group_sync(grp);  // the group's previous tile is consumed
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) {
      const int i = gtid + r * GROUP, d = i / (BK / VEC), j = (i % (BK / VEC)) * VEC;
      stage16<T>(ks, LDT, d, j, kq[r]);
      stage16<T>(vs, LDT, d, j, vq[r]);
    }
    group_sync(grp);
    if (tile + KG < tiles) load_tile(base + KG * BK);
    qs.tile(ks, vs, LDT, base, n, lane);
  }
  qs.finish(merge, grp, gtid, out + (long long)bh * D * n, n, q0, lane);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long q_bstride, long long k_bstride,
           long long v_bstride, int batch, int heads, int n, float scale, float* norms, void* out,
           cudaStream_t s) {
  const dim3 grid((n + BQ - 1) / BQ, batch * heads);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  cudaError_t err;
  if (n <= ROW_N) {
    constexpr int bytes = RowSmem<T>::BYTES;
    err = cudaFuncSetAttribute(flash_row<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_row<T><<<grid, THREADS, bytes, s>>>(qt, kt, vt, q_bstride, k_bstride, v_bstride, heads, n,
                                              scale, o);
    return (int)cudaGetLastError();
  }
  const int rows = batch * heads * D;
  const int warps = NORM_THREADS / 32;
  row_norms<T><<<(2 * rows + warps - 1) / warps, NORM_THREADS, 0, s>>>(qt, kt, q_bstride, k_bstride,
                                                                        heads, n, rows, norms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int bytes = TileSmem<T>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd<T><<<grid, THREADS, bytes, s>>>(qt, kt, vt, q_bstride, k_bstride, v_bstride, heads, n,
                                            norms, scale, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that fa_forward needs: the norms of every row of q and k (used above
// N = 256).
long long fa_workspace_floats(int batch, int heads) { return 2LL * batch * heads * D; }

// Launches the kernel (N <= 256: one launch) or the norm pre-pass and the kernel on `stream`;
// returns cudaGetLastError() after the first launch that fails, else 0. q, k, v are
// (B, heads, 32, N) in bf16 if is_bf16, else fp32, each with its own batch stride and
// contiguous within a batch element; out is contiguous in the same dtype. The workspace holds
// fa_workspace_floats(batch, heads).
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
