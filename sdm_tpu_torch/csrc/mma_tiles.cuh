// Tensor-core building blocks shared by the port's mma.sync kernels: the
// attention kernels (attention_tiles.cuh, attention.cu) and the GEMM
// (linear.cu). Plain inline PTX for sm_80+: cp.async (16-byte copies into
// shared memory, with a zero-filling variant for rows past a matrix's
// edge), ldmatrix, mma.sync m16n8k16 bf16 with fp32 accumulation, and the
// paired stores of an accumulator fragment.
#pragma once

#include "common.cuh"

typedef __nv_bfloat16 bf16;

// Whether a pointer is 16-byte aligned, as cp.async and ldmatrix need.
static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// cp_async16 that writes 16 zero bytes instead where `valid` is false (the
// src-size operand 0: nothing is read, but src must still be a valid
// address).
__device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: a the 4-register bf16 A fragment, (b0, b1)
// the B fragment, c the fp32 accumulator fragment.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// cp.async of `rows` rows x `cpr` 16-byte chunks of a row-major bf16 matrix
// (row stride ss elements) into dst[rows][ld]. This thread copies the chunks
// c = tid + nthreads * i of the row-major (rows, cpr) chunk grid, walked
// incrementally (no division in the loop).
__device__ __forceinline__ void cp_async_rows(bf16* dst, int ld,
                                              const bf16* src, long long ss,
                                              int rows, int cpr, int tid,
                                              int nthreads) {
  const int step_r = nthreads / cpr, step_c = nthreads - step_r * cpr;
  int r = tid / cpr, cc = tid - r * cpr;
  while (r < rows) {
    cp_async16(smem_u32(dst + r * ld + cc * 8), src + (long long)r * ss + cc * 8);
    r += step_r;
    cc += step_c;
    if (cc >= cpr) {
      cc -= cpr;
      ++r;
    }
  }
}
