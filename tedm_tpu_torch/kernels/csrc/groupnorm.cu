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
// there. On the H100 a (batch, group) slab is (C / groups) * H*W elements, 512 KB at most on the
// default UNet (C = 64 at 128^2 in fp32): more than one SM's shared memory, but not more than a
// thread-block cluster's. Two routes, chosen by shape in kernels/groupnorm.py (gn_route):
//   - gn_cluster, one launch: a cluster of 2, 4 or 8 CTAs for each (batch, group) pair. Each CTA
//     brings its share of the slab into shared memory by bulk copies on an mbarrier where the
//     slab is 16-byte aligned (else one element a load), and sums x and x^2 in fp32 from there.
//     The CTAs exchange their two partials through distributed shared memory; each CTA combines
//     them in rank order (the same statistics in every CTA and from run to run), forms its
//     channels' affines (gn::film_affine) and writes SiLU of the affine of its share from shared
//     memory (gn::silu_affine), 16 bytes a store. x is read once and out written once: the bytes
//     of the bound. gn_route takes the cluster size that runs the pairs in the fewest rounds on
//     the card (cudaOccupancyMaxActiveClusters), then the smallest.
//   - gn_partials + gn_apply, two launches, for a slab that no cluster's shared memory holds
//     (img_size 256 at C = 64 in fp32, a 2 MB slab): grid (B*C, tiles of 2048 elements of one
//     channel); per-tile partials, laid out (B, C, tiles) as group_norm.cuh expects, then each
//     block combines its group's partials and applies. x is read twice from device memory.
// x may have any batch stride; within a batch element it is contiguous. out is contiguous.

#include <cooperative_groups.h>
#include <stdint.h>

#include "group_norm.cuh"
#include "tensor_core.cuh"

namespace {

namespace cg = cooperative_groups;
using gn::bf16;

// ------------------------------------------------------------------ the two-pass route

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
int launch_two_pass(const void* x, long long x_bstride, const float* gamma, const float* beta,
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

// ------------------------------------------------------------------ the cluster route

constexpr int CL_THREADS = 512;
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr int COPY_BYTES = 16 * 1024;   // bytes of one bulk copy

// Dynamic shared memory of one CTA: its share of the slab (16-byte units), then its (s, q)
// partial (16 bytes) and the (a, b) affine of each of the group's channels; kernels/groupnorm.py's
// cluster_smem computes the same, for the route and the occupancy query.
int cluster_smem(int share_units, int cpg) { return share_units * 16 + 16 + 8 * cpg; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 16 bytes of u as fp32 values: 4 of fp32, 8 of bf16
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// One cluster for each (batch, group) pair; CTA `rank` of a cluster takes units [rank *
// share_units, (rank + 1) * share_units) of the pair's slab of 16-byte units. VEC: the slabs and
// out's are 16-byte aligned and whole units; the share comes by bulk copies on an mbarrier, and
// out is written 16 bytes a store. Else one element at a time, loaded by the threads (the same
// split into shares, so the same shared memory).
template <typename TX, typename TF, bool VEC>
__global__ void __launch_bounds__(CL_THREADS)
gn_cluster(const TX* __restrict__ x, long long x_bstride, const float* __restrict__ gamma,
           const float* __restrict__ beta, const TF* __restrict__ scale,
           const TF* __restrict__ shift, long long film_stride, int c, int groups, int hw,
           int share_units, float eps, TX* __restrict__ out) {
  constexpr int V = 16 / sizeof(TX);  // elements in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), size = (int)cluster.num_blocks();
  const int p = blockIdx.x / size, b = p / groups, g = p % groups;
  const int cpg = c / groups, t = threadIdx.x;
  const int len = cpg * hw;  // elements of the slab
  const int u0 = rank * share_units;
  const int units = max(min(u0 + share_units, (len + V - 1) / V) - u0, 0);  // this CTA's
  float2* part = reinterpret_cast<float2*>(smem + (long long)share_units * 16);
  float2* ab = part + 2;
  const TX* src = x + b * x_bstride + (long long)g * len + (long long)u0 * V;
  TX* dst = out + (long long)p * len + (long long)u0 * V;

  if (VEC && t == 0) {  // the share by the copy engine, 16 KB a copy
    tc::mbar_init(&bar, 1);
    tc::mbar_init_fence();
    tc::mbar_arrive_expect_tx(&bar, units * 16);
    for (int off = 0; off < units * 16; off += COPY_BYTES)
      tc::bulk_copy(smem + off, reinterpret_cast<const char*>(src) + off,
                    min(COPY_BYTES, units * 16 - off), &bar);
  }
  // this thread's channel's parameters, in flight while the share arrives
  const int ch = g * cpg + t;
  float pg = 0.f, pb = 0.f, ps = 0.f, pt = 0.f;
  if (t < cpg) {
    const long long film = (long long)b * film_stride + ch;
    pg = gamma[ch];
    pb = beta[ch];
    if (scale) ps = gn::to_float(scale[film]);
    if (shift) pt = gn::to_float(shift[film]);
  }

  float s = 0.f, q = 0.f;
  if (VEC) {
    __syncthreads();  // the barrier is initialised
    tc::mbar_wait(&bar, 0);
    const uint4* vbuf = reinterpret_cast<const uint4*>(smem);
    for (int u = t; u < units; u += CL_THREADS) {
      float v[V];
      unpack(vbuf[u], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += v[e];
        q = fmaf(v[e], v[e], q);
      }
    }
  } else {
    TX* buf = reinterpret_cast<TX*>(smem);
    const int n = min(units * V, len - u0 * V);
    for (int e = t; e < n; e += CL_THREADS) {
      const TX r = src[e];
      buf[e] = r;
      const float v = gn::to_float(r);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  s = gn::block_sum(s, red);
  q = gn::block_sum(q, red);
  if (t == 0) *part = make_float2(s, q);
  cluster_arrive();  // this CTA's partial is written ...
  cluster_wait();    // ... and every CTA's is

  if (t < cpg) {  // the group's statistics from the CTAs' partials, in rank order
    float gs = 0.f, gq = 0.f;
    for (int r = 0; r < size; ++r) {
      const float2 pr = *cluster.map_shared_rank(part, r);
      gs += pr.x;
      gq += pr.y;
    }
    const float count = (float)len, mean = gs / count;
    const float var = fmaxf(gq / count - mean * mean, 0.f);
    ab[t] = gn::film_affine(make_float2(mean, rsqrtf(var + eps)), pg, pb, ps, pt);
  }
  cluster_arrive();  // done reading the other CTAs' shared memory; waited for before exit
  __syncthreads();

  if (VEC) {
    const uint4* vbuf = reinterpret_cast<const uint4*>(smem);
    uint4* vdst = reinterpret_cast<uint4*>(dst);
    const bool whole = hw % V == 0;  // no 16-byte unit spans two channels
    for (int u = t; u < units; u += CL_THREADS) {
      float v[V];
      unpack(vbuf[u], v);
      const int e0 = (u0 + u) * V;
      int chan = e0 / hw;
      if (whole) {
        const float2 a = ab[chan];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = gn::silu_affine(v[e], a);
      } else {
        int next = (chan + 1) * hw;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (e0 + e == next) {
            ++chan;
            next += hw;
          }
          v[e] = gn::silu_affine(v[e], ab[chan]);
        }
      }
      vdst[u] = pack(v);  // rounds to TX as gn::from_float does
    }
  } else {
    const TX* buf = reinterpret_cast<const TX*>(smem);
    const int n = min(units * V, len - u0 * V);
    for (int e = t; e < n; e += CL_THREADS)
      dst[e] = gn::from_float<TX>(gn::silu_affine(gn::to_float(buf[e]), ab[(u0 * V + e) / hw]));
  }
  cluster_wait();  // no CTA leaves while another may still read its partial
}

// cfg and attr for a launch of gn_cluster<TX, TF, VEC> in clusters of `cluster` CTAs of `smem`
// bytes of dynamic shared memory (grid and stream left to the caller)
template <typename TX, typename TF, bool VEC>
cudaError_t configure(int cluster, int smem, cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  cudaError_t err = cudaFuncSetAttribute(gn_cluster<TX, TF, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

int share_units_of(int c, int groups, int hw, int itemsize, int cluster) {
  const long long units = ((long long)(c / groups) * hw * itemsize + 15) / 16;
  return (int)((units + cluster - 1) / cluster);
}

template <typename TX, typename TF, bool VEC>
int launch_cluster(const void* x, long long x_bstride, const float* gamma, const float* beta,
                   const void* scale, const void* shift, long long film_stride, int batch, int c,
                   int groups, int hw, int cluster, float eps, void* out, cudaStream_t s) {
  const int share_units = share_units_of(c, groups, hw, sizeof(TX), cluster);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TX, TF, VEC>(cluster, cluster_smem(share_units, c / groups), cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(batch * groups * cluster);
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, gn_cluster<TX, TF, VEC>, static_cast<const TX*>(x), x_bstride,
                           gamma, beta, static_cast<const TF*>(scale), static_cast<const TF*>(shift),
                           film_stride, c, groups, hw, share_units, eps, static_cast<TX*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TX, typename TF, bool VEC>
int active_clusters(int cluster, int smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TX, TF, VEC>(cluster, smem, cfg, attr);
  if (err != cudaSuccess) return -(int)err;
  cfg.gridDim = dim3(cluster);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gn_cluster<TX, TF, VEC>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The route's cluster-kernel instance for (x dtype, FiLM dtype, vec): fn<TX, TF, VEC>(args...)
#define GN_DISPATCH(fn, ...)                                                         \
  (!x_bf16 ? (vec ? fn<float, float, true>(__VA_ARGS__) : fn<float, float, false>(__VA_ARGS__)) \
   : film_bf16 ? (vec ? fn<bf16, bf16, true>(__VA_ARGS__) : fn<bf16, bf16, false>(__VA_ARGS__)) \
               : (vec ? fn<bf16, float, true>(__VA_ARGS__) : fn<bf16, float, false>(__VA_ARGS__)))

}  // namespace

extern "C" {

// Floats of scratch that gn_forward needs on the two-pass route (cluster 0); the cluster route
// needs none.
long long gn_workspace_floats(int batch, int c, int hw) {
  return 2LL * batch * c * tiles_of(hw);
}

// How many clusters of the cluster route's kernel for these types, `cluster` CTAs of `smem`
// bytes each, the card can hold at once (cudaOccupancyMaxActiveClusters); 0 if it cannot
// schedule one, minus the CUDA error if the query fails.
int gn_active_clusters(int x_bf16, int film_bf16, int vec, int cluster, int smem) {
  return GN_DISPATCH(active_clusters, cluster, smem);
}

// Launches the route on `stream`: cluster 0 the two passes (workspace: gn_workspace_floats),
// else one launch of a cluster of `cluster` CTAs for each (batch, group) pair (no workspace).
// Returns the first CUDA error, else
// 0. x_bf16 says whether x and out are bf16 (else fp32); film_bf16 whether scale and shift are
// bf16 (else fp32; only with bf16 x); vec whether each (batch, group) slab of x is 16-byte
// aligned and a multiple of 16 bytes long (the cluster route's bulk copies and 16-byte stores).
// scale and shift may each be null (no FiLM term); row b of each starts at b * film_stride.
// gamma and beta are fp32 (C,). out is contiguous (B, C, H, W) in x's dtype.
int gn_forward(int x_bf16, int film_bf16, const void* x, long long x_bstride, const float* gamma,
               const float* beta, const void* scale, const void* shift, long long film_stride,
               int batch, int c, int groups, int hw, float eps, int cluster, int vec,
               float* workspace, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    if (!x_bf16)
      return launch_two_pass<float, float>(x, x_bstride, gamma, beta, scale, shift, film_stride,
                                           batch, c, groups, hw, eps, workspace, out, s);
    if (film_bf16)
      return launch_two_pass<bf16, bf16>(x, x_bstride, gamma, beta, scale, shift, film_stride,
                                         batch, c, groups, hw, eps, workspace, out, s);
    return launch_two_pass<bf16, float>(x, x_bstride, gamma, beta, scale, shift, film_stride,
                                        batch, c, groups, hw, eps, workspace, out, s);
  }
  if (cluster > MAX_CLUSTER || c / groups > CL_THREADS) return (int)cudaErrorInvalidValue;
  return GN_DISPATCH(launch_cluster, x, x_bstride, gamma, beta, scale, shift, film_stride, batch,
                     c, groups, hw, cluster, eps, out, s);
}

}  // extern "C"
