// Hopper (sm_90a) building blocks in inline PTX: shared-memory mbarriers,
// 1-D bulk copies from device memory completed on an mbarrier, and
// warpgroup matrix multiplies (wgmma) with both operands read from shared
// memory through descriptors of the 128-byte-swizzled K-major layout.
//
// The layout, for a tile of R rows x 64 bf16 values (128 bytes a row):
// row r starts at byte r * 128 of a 1024-byte-aligned tile, and its 16-byte
// chunk j (values 8j .. 8j+7) is stored at chunk j ^ (r % 8). This is what
// a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes; here it is written by
// ordinary stores (the A operand) or by a pack kernel into device memory
// and moved as one contiguous block (the B operand).
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (bulk copies)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------ bulk copies

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared
// memory to device memory, in the thread's bulk group; the source must
// stay unchanged until bulk_store_wait_read
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// the thread's bulk stores have read their shared-memory sources
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// asks L2 to fetch `bytes` (a multiple of 16) of device memory at `src`
// (16-byte aligned); no completion to wait for
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// ordinary (generic-proxy) shared-memory stores become visible to wgmma
// (the async proxy) after this fence and a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a warpgroup), id 1..15
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// descriptor of a K-major operand in the 128-byte swizzle: start address
// in 16-byte units (bits 0-13), leading offset unused for this layout (1),
// stride offset 1024 bytes between 8-row groups (bits 32-45), swizzle mode
// 1 = 128 bytes (bits 62-63); the tile must be 1024-byte aligned. One k16
// step within a 64-wide tile advances the start by 32 bytes, i.e. + 2.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// descriptor of an MN-major operand in the 128-byte swizzle: rows of
// 128 bytes run along K (64 M or N values a row, chunk j of row r at
// chunk j ^ (r % 8)), 8-row groups `sbo` bytes apart along K, and the
// next 64 values of M or N `lbo` bytes on. One k16 step advances the
// start by 16 rows (+ 2048 bytes, + 128 here). Read with the transpose
// flag of wgmma set for that operand.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t smem_addr,
                                                  uint32_t lbo,
                                                  uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma fence or wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x 128 fp32, 64 registers a thread) = A (64 x 16 bf16) B (16 x 128
// bf16) + (accumulate ? d : 0), read through descriptors; A and B K-major,
// or MN-major where TRANS_A / TRANS_B is 1.
// Thread t of the warpgroup holds, for j = 0..15, d[4j + 2h + e] at row
// 16 (t / 32) + (t % 32) / 4 + 8 h and column 8 j + 2 (t % 4) + e.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
        "n"(TRANS_B));
}


}  // namespace
