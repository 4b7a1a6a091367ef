// What the Hopper (sm_90a) attention kernels share: the PTX of TMA loads,
// mbarriers and wgmma issue, the 128-byte-swizzle matrix descriptor, the
// exponent and bf16 packing, and the host side of the 4-D TMA tensor maps
// over the caller's (B, N, H, 64) strides. The forward
// (csrc/flash_fwd_sm90.cuh) and the backward (csrc/flash_bwd_sm90.cuh)
// build on it.

#pragma once

#include <cuda.h>  // CUtensorMap and the CUDA driver API's enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace flash_sm90 {

using flash::wgmma_rs;
using flash::wgmma_ss;

constexpr int kD = 64;          // head dim: one bf16 row is 128 bytes
constexpr int kRowBytes = 128;  // = the swizzle width

// --- PTX --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts ~10 s of clock (a wrong phase would hang) traps instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 4096) t0 = clock64();
    if (tries > 4096 && (tries & 1023) == 0 && clock64() - t0 > 20000000000LL)
      __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (Q, K):
// lbo unused, sbo = 1024 (the next 8 rows). MN-major (V): lbo = the next 64
// columns, sbo = 1024 (the next 8 keys).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// P (or dS) as the A operand of a register-A wgmma: the fp32 accumulators
// a (the D layout of csrc/wgmma_sm90.cuh) rounded to bf16 pairs, x[i] =
// (a[2i], a[2i + 1]); k-step kk of a product reads x + 4 * kk.
template <int N>
__device__ __forceinline__ void pack_acc(uint32_t* x, const float* a) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = pack_bf16(a[2 * i], a[2 * i + 1]);
}

// acc (64 x N) = A B^T over D = 64: A the 64 rows at a_addr, B the N rows
// at b_addr, both [row][64] bf16 tiles under the 128-byte swizzle, read
// K-major: 4 k-steps of 16 of D, each 32 bytes further along the rows.
template <int N>
__device__ __forceinline__ void gemm_ss_nt(float* acc, uint32_t a_addr,
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<N>(acc, sw128_desc(a_addr + kk * 32, 0, 1024),
                sw128_desc(b_addr + kk * 32, 0, 1024), kk > 0);
}

// acc (64 x N) += X B: X (64 x K) in registers (pack_acc), B the K rows at
// b_addr of a [row][64] tile read MN-major: K / 16 k-steps of 16 rows
// (2048 bytes). Columns past 64 come from the tile `lbo` bytes on.
template <int N, int K>
__device__ __forceinline__ void gemm_rs_mn(float* acc, const uint32_t* x,
                                           uint32_t b_addr, uint32_t lbo = 0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N>(acc, x + 4 * kk, sw128_desc(b_addr + kk * 2048, lbo, 1024));
}

// The shared-space address of the first 1024-byte boundary (the swizzle
// atom) at or after `raw`.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// TMA coordinates (after D) of row `row`, head h, batch b in a map whose
// dims are (D, H, N, B), or (D, N, H, B) when `swap`.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int swap, int h,
                                          int row, int b) {
  if (swap)
    tma_load(dst, map, bar, row, h, b);
  else
    tma_load(dst, map, bar, h, row, b);
}

// --- host: tensor maps ------------------------------------------------------

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime so
// that nothing links -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// Error codes of the entries beyond cudaError_t.
constexpr int kErrNoEncoder = 10001;  // no cuTensorMapEncodeTiled
constexpr int kErrMap = 10002;        // the CUDA driver refused a map

// A 4-D map over a bf16 (B, N, H, 64) tensor with element strides (sb, sn,
// sh), `rows` tokens (reads past them give zeros), boxes of 64 x box_rows.
// The two middle dims go in order of stride; *swap says which order.
inline int make_map(CUtensorMap* map, const void* ptr, int64_t batch,
                    int64_t heads, int64_t rows, int64_t sb, int64_t sn,
                    int64_t sh, int box_rows, int* swap) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  *swap = sn < sh;
  const cuuint64_t n = static_cast<cuuint64_t>(rows > 0 ? rows : 1);
  const cuuint64_t hd = static_cast<cuuint64_t>(heads);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), *swap ? n : hd,
                        *swap ? hd : n, static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {
      static_cast<cuuint64_t>((*swap ? sn : sh) * 2),
      static_cast<cuuint64_t>((*swap ? sh : sn) * 2),
      static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t br = static_cast<cuuint32_t>(box_rows);
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), *swap ? br : 1u,
                       *swap ? 1u : br, 1u};
  cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrMap;
}

}  // namespace flash_sm90
