// Building blocks shared by the flash-attention kernels (forward and
// backward): mma.sync m16n8k16 on bf16 with fp32 accumulation, ldmatrix
// loads of 8x8 bf16 tiles from shared memory, and the 64-row tile copy from
// a strided (tokens, 64) bf16 matrix into shared memory.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                         a[2] = A[g][2t+8..],     a[3] = A[g+8][2t+8..]
//   B (16x8, col major):  b0 = B[2t..2t+1][g],     b1 = B[2t+8..2t+9][g]
//   C (16x8 fp32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// so the accumulators of two neighbouring 8-column n-tiles are, packed to
// bf16, the A fragment of one 16-deep k-slice (see pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;         // rows per tile (q rows or keys); D = 64
constexpr int kThreads = 128;     // 4 warps x 16 rows
constexpr int kHPitch = 72;       // bf16 per shared-memory row (144 bytes)

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of n-tiles 2t and 2t+1 as the A fragment of k-slice t.
__device__ __forceinline__ void acc_to_a_frag(uint32_t* a, const float* lo,
                                              const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows [row0, row0 + 64) of a (tokens, 64) bf16 matrix -> dst[row][d] in
// shared memory; rows at or past `limit` are zeros. Eight consecutive
// threads copy one row (128 contiguous bytes).
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int64_t row_stride, int row0,
                                               int limit) {
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i / 8;
    const int c = (i % 8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kHPitch + c) = val;
  }
}

// This warp's 16 rows of a 64-row shared tile as 4 A fragments (one per
// 16-wide slice of D).
__device__ __forceinline__ void load_a_frags(uint32_t (*frag)[4],
                                             const __nv_bfloat16* tile,
                                             int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(frag[kk], &tile[(warp * 16 + lane % 16) * kHPitch + kk * 16 +
                                (lane / 16) * 8]);
}

// acc (16 x 64) = A (this warp's 16 rows x 64 of D, fragments) times the
// transpose of a 64-row shared tile: acc[j] holds columns (tile rows)
// j*8 .. j*8+7.
__device__ __forceinline__ void mma_a_times_tile_t(float (*acc)[4],
                                                   uint32_t (*a)[4],
                                                   const __nv_bfloat16* tile,
                                                   int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t bf[4];  // b-fragments of n-tiles j and j+1
      ldmatrix_x4(bf, &tile[(j * 8 + (lane / 16) * 8 + lane % 8) * kHPitch +
                            kk * 16 + ((lane / 8) % 2) * 8]);
      mma_bf16(acc[j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// out (16 x 64 of D) += X (16 x 64, the fp32 accumulators x, rounded to
// bf16) times a 64-row shared tile: the tile's rows are the contraction.
__device__ __forceinline__ void mma_acc_times_tile(float (*out)[4],
                                                   float (*x)[4],
                                                   const __nv_bfloat16* tile,
                                                   int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t pa[4];
    acc_to_a_frag(pa, x[2 * t], x[2 * t + 1]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t bf[4];  // b-fragments of dim tiles j and j+1
      ldmatrix_x4_trans(bf, &tile[(t * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      kHPitch + j * 8 + (lane / 16) * 8]);
      mma_bf16(out[j], pa, bf[0], bf[1]);
      mma_bf16(out[j + 1], pa, bf[2], bf[3]);
    }
  }
}

// Row r (0: lane/4, 1: lane/4 + 8) of this warp's 16 x 64 accumulator,
// times `mul`, stored into row `row` of a strided (tokens, 64) matrix:
// rounded to bf16, or as fp32 (the ring's per-pair partials and stats).
__device__ __forceinline__ void store_row(__nv_bfloat16* base,
                                          int64_t row_stride, int row,
                                          float (*acc)[4], int r, float mul,
                                          int lane) {
  __nv_bfloat16* dst = base + static_cast<int64_t>(row) * row_stride +
                       (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
        acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
}

__device__ __forceinline__ void store_row(float* base, int64_t row_stride,
                                          int row, float (*acc)[4], int r,
                                          float mul, int lane) {
  float* dst = base + static_cast<int64_t>(row) * row_stride + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float2*>(dst + j * 8) =
        make_float2(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
}

}  // namespace flash
