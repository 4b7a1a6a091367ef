// P^T dO for Hopper (sm_90a) on TMA and wgmma: the kernel behind
// csrc/flash_attn_pt_do_sm90.cu.
//
// What it computes, with s' = q.k * d^-1/2 * log2(e) and the forward's
// base-2 lse of each q row (+inf for a row that saw no key):
//   out_j = sum_i exp2(s'_ij - lse_i) dO_i,   fp32 (B, Nk, H, 64),
// the key-major pass's dV arm alone (csrc/flash_bwd_sm90.cuh) without V,
// delta, dP, dS and dK. The ring's lse-cotangent backward
// (ops/ring_attention.py::RingFlashAttentionWithLse) runs it once per
// (q shard, kv shard) pair with dO := g_lse * q * d^-1/2 * log2(e).
//
// What bounds it: two products of 2 * 64 flops per score (S^T = K Q^T and
// out += P^T dO) against one exponential per score, the forward's ratio,
// so the tensor cores bound it (utils/flops.py::roofline_ms, "pt_do"). The
// exponentials of a 64 x 64 tile take the SM's special-function units
// (16 a clock) about half as long as the tile's two products take the
// tensor cores (1024 multiply-adds a clock), so they have to run beside
// the products.
//
// Design (the key-major pass of csrc/flash_bwd_sm90.cuh, on the PTX and
// tensor maps of csrc/sm90_common.cuh):
//   * Warp specialisation: one consumer warpgroup owns 64 keys, whose K
//     rows one TMA load brings in once; a producer warp streams 64-row
//     tiles of Q and dO by TMA through a ring of kPtStages stages with
//     full/empty mbarriers. Its 32 lanes copy each stage's 64 lse values
//     (rows Nq * 4 bytes apart, which TMA refuses at the frame layers'
//     1369 tokens) and arrive on the stage's full barrier. Two blocks an
//     SM.
//   * Per tile: S^T = K Q^T by wgmma from shared memory (both K-major),
//     P^T = exp2(S^T * qscale - lse) in registers, out += P^T dO by wgmma
//     with P^T as the register A operand (bf16) and the dO tile MN-major.
//   * Tile j's S^T starts together with tile j - 1's P^T dO, and tile j's
//     exponentials run while that product does (the dQ pass's schedule).
//   * The registers the backward's dK/dV pass needed for dP^T, dS^T and dK
//     are free here (out, S^T and the bf16 P^T live), so the overlap does
//     not spill (ptxas: 108 registers a thread).
//   * This configuration was the fastest of those tried on an H100: two
//     or three warpgroups a block, no overlap, 3 stages (PERF.md).
//   * Masking: the Q and dO maps end at nq, so TMA reads zero rows past
//     it, whose lse the producer sets to +inf: P = 0. The K map ends at nk;
//     keys past it get P = 0 and their rows are not written. A block whose
//     q rows are all absent (nq = 0) writes zeros.

#pragma once

#include "flash_bwd_sm90.cuh"

namespace flash_sm90 {

constexpr int kPtStages = 4;  // streamed Q/dO stages

struct PtParams {
  const float* lse;  // (B, H, Nq), contiguous
  float* out;        // (B, Nk, H, 64) fp32, element strides o_sb, o_sn, o_sh
  int64_t o_sb, o_sn, o_sh;
  int heads, nq, nk;
  int swap_q, swap_k, swap_do;  // map dims (D, N, H, B)
  float qscale;                 // d^-1/2 * log2(e)
};

// Shared memory from a 1024-aligned base: the owned K tile, each stage's
// Q and dO tiles, each stage's lse slice, the barriers.
struct PtSmem {
  static constexpr int kStages = kPtStages;
  static constexpr int kOffStage = kBwdTileBytes;
  static constexpr int kOffRows = kOffStage + 2 * kStages * kBwdTileBytes;
  static constexpr int kOffBar = kOffRows + kStages * kBwdRows * 4;
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;

  uint32_t base;  // shared-space address, 1024-aligned
  float* rows;    // the lse slices
  // the block's 64 keys
  __device__ __forceinline__ uint32_t own() const { return base; }
  // streamed tile i (0: Q, 1: dO) of stage st
  __device__ __forceinline__ uint32_t tile(int st, int i) const {
    return base + kOffStage + (2 * st + i) * kBwdTileBytes;
  }
  __device__ __forceinline__ float* lse(int st) const {
    return rows + st * kBwdRows;
  }
  // barriers: 0 own_full, 1 + st full, 1 + kStages + st empty
  __device__ __forceinline__ uint32_t own_full() const {
    return base + kOffBar;
  }
  __device__ __forceinline__ uint32_t full(int st) const {
    return base + kOffBar + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return base + kOffBar + 8 * (1 + kStages + st);
  }
};

// P^T of one tile, in place: s holds S^T (this thread's key rows r = 0, 1
// by q columns 8j + 2t + c & 1), lse the tile's q-row slice. Keys that are
// not live get 0.
__device__ __forceinline__ void pt_probs(float* s, const float* lse,
                                         const bool* live, float qscale,
                                         int t) {
#pragma unroll
  for (int j = 0; j < kBwdRows / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = 4 * j + c;
      s[x] = live[c / 2] ? ex2(fmaf(s[x], qscale, -(c & 1 ? l.y : l.x)))
                         : 0.f;
    }
  }
}

// One block per (64 keys, batch * head). Consumer thread rows: keys key0
// and key0 + 8; accumulator column 8j + 2t + c of S^T is q row 8j + 2t + c
// of the tile.
__global__ void __launch_bounds__(128 + 32, 2)
    flash_bwd_pt_do_sm90_kernel(const PtParams prm,
                                const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_do) {
  constexpr int kS = kBwdAcc;
  constexpr int kStages = kPtStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const PtSmem sm{base, reinterpret_cast<float*>(
                          smem_raw + (base - smem_u32(smem_raw)) +
                          PtSmem::kOffRows)};
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), 32);
      mbar_init(sm.empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.y, b = bh / prm.heads, h = bh % prm.heads;
  const int n0 = blockIdx.x * kBwdRows;
  const int ntiles = (prm.nq + kBwdRows - 1) / kBwdRows;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= 128) {  // the producer warp
    if (ntiles > 0) {
      const float* lse = prm.lse + static_cast<int64_t>(bh) * prm.nq;
      if (lane == 0) {
        mbar_expect_tx(sm.own_full(), kBwdTileBytes);
        load_rows(sm.own(), &map_k, sm.own_full(), prm.swap_k, h, n0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        mbar_wait(sm.empty(st), ((i / kStages) & 1) ^ 1);
        for (int r = lane; r < kBwdRows; r += 32) {
          const int row = i * kBwdRows + r;
          sm.lse(st)[r] = row < prm.nq ? lse[row] : INFINITY;
        }
        if (lane == 0) {
          mbar_expect_tx(sm.full(st), 2 * kBwdTileBytes);
          load_rows(sm.tile(st, 0), &map_q, sm.full(st), prm.swap_q, h,
                    i * kBwdRows, b);
          load_rows(sm.tile(st, 1), &map_do, sm.full(st), prm.swap_do, h,
                    i * kBwdRows, b);
        } else {
          mbar_arrive(sm.full(st));
        }
      }
    }
    return;
  }

  const int t = lane % 4;
  const int key0 = n0 + (threadIdx.x / 32) * 16 + lane / 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (ntiles > 0) {
    const bool live[2] = {key0 < prm.nk, key0 + 8 < prm.nk};
    const uint32_t keys = sm.own();
    float s[kS];          // S^T, then P^T
    uint32_t p[kS / 2];   // P^T as the bf16 A operand
    mbar_wait(sm.own_full(), 0);
    // tile 0: its scores alone
    mbar_wait(sm.full(0), 0);
    wg_fence();
    gemm_ss_nt<kBwdRows>(s, keys, sm.tile(0, 0));
    wg_commit();
    wg_wait<0>();
    pin<kS>(s);
    pt_probs(s, sm.lse(0), live, prm.qscale, t);
    pack_acc<kS>(p, s);
    int prev = 0;
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages;
      mbar_wait(sm.full(st), (j / kStages) & 1);
      pin<32>(acc);
      pin<kS / 2>(p);
      wg_fence();
      gemm_ss_nt<kBwdRows>(s, keys, sm.tile(st, 0));
      wg_commit();
      gemm_rs_mn<64, kBwdRows>(acc, p, sm.tile(prev, 1));
      wg_commit();
      wg_wait<1>();  // tile j's scores are done, j - 1's product runs on
      pin<kS>(s);
      pt_probs(s, sm.lse(st), live, prm.qscale, t);
      wg_wait<0>();
      pin<32>(acc);
      pin<kS / 2>(p);
      mbar_arrive(sm.empty(prev));
      pack_acc<kS>(p, s);
      prev = st;
    }
    pin<32>(acc);
    pin<kS / 2>(p);
    wg_fence();
    gemm_rs_mn<64, kBwdRows>(acc, p, sm.tile(prev, 1));
    wg_commit();
    wg_wait<0>();
    pin<32>(acc);
    pin<kS / 2>(p);
    mbar_arrive(sm.empty(prev));
  }
  store_acc(prm.out + b * prm.o_sb + h * prm.o_sh, prm.o_sn, acc, 1.f, key0,
            prm.nk, t);
}

// --- host: the launch -------------------------------------------------------

// st: the 12 element strides (batch, token, head) of q, k, dout and out.
// Returns 0 or an error code (cudaError_t, or kErrNoEncoder / kErrMap of
// csrc/sm90_common.cuh).
inline int launch_pt_do(const void* q, const void* k, const void* dout,
                        const void* lse, void* out, int64_t batch,
                        int64_t heads, int64_t nq, int64_t nk,
                        const int64_t* st, float qscale, void* stream) {
  if (batch * heads == 0 || nk == 0) return 0;
  const auto kernel = flash_bwd_pt_do_sm90_kernel;
  constexpr int kSmem = PtSmem::kBytes;
  // once per library (see the forward's launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  PtParams prm;
  CUtensorMap mq, mk, mdo;
  int err = make_map(&mq, q, batch, heads, nq, st[0], st[1], st[2],
                     kBwdRows, &prm.swap_q);
  if (!err)
    err = make_map(&mk, k, batch, heads, nk, st[3], st[4], st[5],
                   kBwdRows, &prm.swap_k);
  if (!err)
    err = make_map(&mdo, dout, batch, heads, nq, st[6], st[7], st[8],
                   kBwdRows, &prm.swap_do);
  if (err) return err;
  prm.lse = static_cast<const float*>(lse);
  prm.out = static_cast<float*>(out);
  prm.o_sb = st[9];
  prm.o_sn = st[10];
  prm.o_sh = st[11];
  prm.heads = static_cast<int>(heads);
  prm.nq = static_cast<int>(nq);
  prm.nk = static_cast<int>(nk);
  prm.qscale = qscale;
  const dim3 grid(static_cast<unsigned>((nk + kBwdRows - 1) / kBwdRows),
                  static_cast<unsigned>(batch * heads));
  kernel<<<grid, 128 + 32, kSmem, static_cast<cudaStream_t>(stream)>>>(
      prm, mq, mk, mdo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_sm90
