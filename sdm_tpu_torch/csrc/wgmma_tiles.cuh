// Hopper (sm_90a) tensor-core building blocks: TMA tile loads into shared
// memory, which async_tiles.cuh's mbarriers report, and warpgroup MMAs
// (wgmma) that read both operands from shared memory through matrix
// descriptors. Used by the GEMM (linear.cu), the whole-S attention
// (attention.cu) and the streaming attention's forward and its dK and dQ
// passes (streaming_attention.cu). One copy of each primitive lives here or in
// async_tiles.cuh.
//
// The tiles are bf16, 64 elements (128 bytes) a row, as TMA writes them with
// CU_TENSOR_MAP_SWIZZLE_128B: row r of a tile at byte r * 128, its 16-byte
// chunk c at chunk c ^ (r % 8). Each tile starts 1024-byte aligned, so that
// pattern repeats every eight rows and a descriptor's base offset is 0. A
// wgmma operand reads such a tile K-major (its rows are the operand's M or N
// rows, 64 deep along K: x and W, Q and K) or MN-major (its rows are K, 64
// wide along N: V in P V). tests/test_torch_linear_wgmma.py and
// tests/test_torch_attention_wgmma.py emulate this layout, the descriptors'
// addressing and the accumulator fragments on the CPU.
#pragma once

#include <cuda.h>   // CUtensorMap and the driver's enums only; no linking

#include "async_tiles.cuh"

// ---------------------------------------------------------------- TMA (host)

typedef CUresult (*sdm_encode_tiled_fn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, fetched through the
// runtime (the libraries link no libcuda). Null where the driver lacks it.
static sdm_encode_tiled_fn sdm_encode_tiled() {
  static sdm_encode_tiled_fn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<sdm_encode_tiled_fn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major bf16 matrix (rows x cols, row stride ld
// elements; base 16-byte aligned, ld % 8 == 0) read in boxes of `box_rows`
// rows x 64 columns, 128B-swizzled. Boxes past the matrix's edge are
// zero-filled. Returns a cudaError_t.
static int sdm_tma_map_bf16(CUtensorMap* map, const void* base, int rows,
                            int cols, long long ld, int box_rows) {
  const sdm_encode_tiled_fn encode = sdm_encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA map of an (N, S, H, D) bf16 tensor with element strides sn, ss
// and sh and a unit D stride (a strided view of a qkv buffer is fine; base
// 16-byte aligned, every stride % 8 == 0), read in boxes of `box_rows` rows
// of S by `chunks` 64-column chunks of D at one (n, h): a rank-5 map over
// (64 columns, S, D / 64 chunks, H, N), so that a box lands in shared
// memory as `chunks` consecutive 128B-swizzled tiles of box_rows x 64, each
// as a K-major (or MN-major) wgmma operand reads it. Boxes past S or D are
// zero-filled, never read from the next row of the batch. One load of
// several chunks: the TMA unit's cost is mostly per load (on the H100,
// tools/torch_attention_tiles.py: 8 KB loads streamed at 3.3 TB/s over the
// card, 16 KB at 6.6, 32 KB at 7.6). Returns a cudaError_t.
static int sdm_tma_map_chunks(CUtensorMap* map, const void* base, int n,
                              int s, int h, int d, long long sn, long long ss,
                              long long sh, int box_rows, int chunks) {
  const sdm_encode_tiled_fn encode = sdm_encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {64, (cuuint64_t)s, (cuuint64_t)(d / 64),
                              (cuuint64_t)h, (cuuint64_t)n};
  // A head axis of one is never stepped; give it the row stride.
  const cuuint64_t strides[4] = {(cuuint64_t)ss * sizeof(bf16),
                                 64 * sizeof(bf16),
                                 (cuuint64_t)(h > 1 ? sh : ss) * sizeof(bf16),
                                 (cuuint64_t)sn * sizeof(bf16)};
  const cuuint32_t box[5] = {64, (cuuint32_t)box_rows, (cuuint32_t)chunks, 1,
                             1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ TMA (device)

// One box of `map` at (col, row) into shared memory at dst (1024-byte
// aligned), completing `bytes` of bar's transactions when it lands.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// One box of a rank-5 map (sdm_tma_map_chunks) whose first row is `s`
// and first chunk `chunk`, at (n, h).
__device__ __forceinline__ void tma_load_chunks(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int s,
                                                int chunk, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(s), "r"(chunk), "r"(h), "r"(n)
      : "memory");
}

// ------------------------------------------------------------ named barriers

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32: the consumer warpgroups meet without the producer warp.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// The shared-memory matrix descriptor of a K-major bf16 tile in the
// 128B-swizzled layout above, starting at `p`: start address >> 4 (bits
// 0-13), leading byte offset 1 (unused by swizzled K-major layouts, bits
// 16-29), stride byte offset 1024 >> 4 (eight 128-byte rows to the next
// 8-row group, bits 32-45), base offset 0 (bits 49-51), layout 1 = 128B
// swizzle (bits 62-63). The k-th 16-deep step of a 64-wide row adds
// 32 k bytes to the start: 2 k in the low field.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The descriptor of an MN-major bf16 operand in the same layout: B (N x K)
// stored K rows of 64 N-columns, as TMA writes a box of V (keys x columns).
// In PTX's canonical MN-major 128B-swizzle layout, ((8, 8, m), (8, k)) :
// ((1, 8, LBO), (64, SBO)) in elements, element (n, k) lies at byte 2 (n %
// 64) + 128 (k % 8) + LBO (n / 64) + SBO (k / 8) before the swizzle: SBO is
// the stride of eight K rows (1024 bytes) and LBO that of the next 64
// columns. The wrappers below read one 64-column atom an instruction (N =
// 64), so LBO is never stepped; it is set to 1024 too, which makes the
// encoding right whichever of the two fields the hardware takes for the K
// stride. The k-th 16-deep step adds 16 rows, 2048 bytes: 128 k in the low
// field.
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// Orders this warpgroup's register and shared-memory writes before the
// wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B^T for one m64nNk16 step: A (64 x 16) and B (N x 16), both K-major
// bf16 in shared memory, named by their descriptors (scale-d 1: accumulate,
// or d = A B^T where a wrapper's `accumulate` is 0, so that no other
// instruction need write the accumulators; no transposes). d is this thread's N / 2 fp32 accumulators: in warp w of
// the warpgroup, lane l = 4 g + t holds rows 16 w + g (d[4 j], d[4 j + 1])
// and 16 w + g + 8 (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t and
// 8 j + 2 t + 1.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B^T with B MN-major (wgmma_desc_mn; the transpose-B bit set): A
// (64 x 16) K-major as above, B (64 x 16) read from 16 K rows of 64
// columns. Same fragments as wgmma_m64n64k16.
__device__ __forceinline__ void wgmma_m64n64k16_mn(float (&d)[32], uint64_t da,
                                                   uint64_t db,
                                                   int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma widths 64/128/256");
  if constexpr (N == 64)
    wgmma_m64n64k16(d, da, db);
  else if constexpr (N == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n256k16(d, da, db);
}

// ------------------------------------------------- accumulator epilogue

// Two fp32 values rounded to one bf16x2 (a at the lower address).
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void unpack_bf16x8(const unsigned (&pk)[4],
                                              float v[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&pk[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// A 4 x 4 transpose across a quad (lanes 4 g + t, t = 0..3, all lanes of
// the warp taking part): afterwards v[p] of lane t is what v[t] of lane p
// was. In an accumulator fragment v[jj] of lane t is the column pair t of
// 8-column block jj; afterwards lane t holds block t's eight columns.
__device__ __forceinline__ void quad_transpose4(unsigned (&v)[4], int t) {
  auto pick = [&](int i) {
    return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
  };
  // Lane t ^ r sends its v[t] (pick((t ^ r) ^ r) on its side).
  const unsigned got0 = pick(t);
  const unsigned got1 = __shfl_xor_sync(0xffffffffu, pick(t ^ 1), 1);
  const unsigned got2 = __shfl_xor_sync(0xffffffffu, pick(t ^ 2), 2);
  const unsigned got3 = __shfl_xor_sync(0xffffffffu, pick(t ^ 3), 3);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = p ^ t;
    v[p] = r == 0 ? got0 : r == 1 ? got1 : r == 2 ? got2 : got3;
  }
}
