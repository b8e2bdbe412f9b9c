// Tensor-core device code shared by the flash cosine-attention kernel (flash_attention.cu) and
// the ResnetBlock kernel (resblock.cu), for Hopper (sm_90a), as inline PTX:
//   - TF32 rounding and the split of an fp32 value into two TF32 parts, x = hi + lo, so that an
//     fp32 product runs on the tensor cores as hi*hi + hi*lo + lo*hi (the lo*lo term, 2^-22 of
//     the product, is dropped); bf16 values are exact in TF32 and need no lo part;
//   - the split of an fp32 value into two bf16 parts, for a product with a bf16 operand (bf16
//     values are exact in bf16) as two bf16 products;
//   - mma.sync m16n8k8 TF32 and m16n8k16 bf16, ldmatrix (and transposed);
//   - wgmma m64n64 (k16 bf16, k8 TF32) with A from registers and B from shared memory through
//     a descriptor of the no-swizzle K-major layout; mbarriers and the bulk async copy (the
//     non-tensor form of TMA) that fills B.
//
// The B tiles of wgmma here are in the canonical no-swizzle K-major layout: core matrices of 8
// rows (of N) by 16 bytes (of K), each 128 contiguous bytes; the two core matrices of one
// k-step (16 bf16 or 8 TF32 values of K) lie LBO = 128 bytes apart, successive groups of 8 rows
// of N SBO = 256 bytes apart, so one k-step of a 64-wide N is 2048 contiguous bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// ---------------------------------------------------------------- TF32

// x rounded to TF32 (10 explicit mantissa bits; nearest, ties away from zero), as fp32 bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t hi, lo;
};

// hi = tf32(x), lo = tf32(x - hi): x = hi + lo to 2^-22 of |x|
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a b, one m16n8k8 product: TF32 operands, fp32 accumulators. Fragments (g = lane / 4,
// t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g),
// b1 (k = t + 4, n = g); d0, d1 (g, 2t and 2t + 1), d2, d3 (g + 8, 2t and 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(  // not volatile: the compiler may interleave independent products
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- bf16

// (a, b) as a bf16 pair, a in the low half, and the pair of what that left, rounded: a = hi + lo
// to 2^-16 of |a|. hi truncates (its bits are a's upper half), so that one conversion makes
// both pairs: an fp32 operand of a bf16 product taken as two bf16 products.
__device__ __forceinline__ Split split_bf16x2(float a, float b) {
  const uint32_t ua = __float_as_uint(a) & 0xffff0000u, ub = __float_as_uint(b) & 0xffff0000u;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a - __uint_as_float(ua), b - __uint_as_float(ub));
  return {__byte_perm(ua, ub, 0x7632), *reinterpret_cast<const uint32_t*>(&lo)};
}

// d += a b, one m16n8k16 product: bf16 pairs (the lower k in the low half), fp32 accumulators.
// a0 (g, k 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t..2t+1,
// n = g), b1 (k 2t + 8.., n = g); d as in mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices of 16-bit values (8 rows of 16 bytes each); lane l gives the row address
// of row l % 8 of matrix l / 8 and receives, in r[i], the 4 bytes at row l / 4, bytes
// 4 (l % 4) .. of matrix i. For 32-bit values that is element (l / 4, l % 4) of an 8 x 4 matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same matrices transposed: lane l receives, in r[i], the values at rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4 of matrix i (the first in the low half)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---------------------------------------------------------------- mbarrier and bulk copy

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes initialised barriers visible to the other threads and to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also expects `bytes` from asynchronous copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of the given parity has completed; traps (a launch failure the host
// sees) after some 2^34 cycles, several seconds, rather than hang the card on a lost copy
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1LL << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to shared memory by the
// copy engine; their arrival completes the barrier's expected transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// A descriptor of a B operand in the no-swizzle K-major layout (see the header)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  constexpr uint64_t LBO = 128, SBO = 256;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place: the compiler may not reuse or move them across this point. Used on
// the accumulators around asynchronous products, and on an A fragment after the wait that
// retires the products reading it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 fp32 over the warpgroup) += a b. a: this thread's part of a 64 x K tile in
// registers, warp w holding rows 16w .. 16w + 15 in the mma.sync A layout (bf16 pairs for k16,
// TF32 values for k8); b: K x 64 at desc. d[4j + i] holds row 16w + g (+ 8 for i >= 2), column
// 8j + 2t + (i & 1).
#define TC_D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_D32_OPERANDS(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : TC_D32_OPERANDS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TC_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : TC_D32_OPERANDS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1)
      : "memory");
}

#undef TC_D32
#undef TC_D32_OPERANDS

}  // namespace tc
