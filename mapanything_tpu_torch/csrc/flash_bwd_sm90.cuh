// The flash-attention backward for Hopper (sm_90a) on TMA and wgmma: the
// kernel templates behind csrc/flash_attn_bwd_sm90.cu.
//
// What they compute, with s' = q.k * d^-1/2 * log2(e), the forward's base-2
// lse and delta = rowsum(dO * O) (computed by the caller):
//   P = exp2(s' - lse),  dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dK = dS^T Q * d^-1/2,  dQ = dS K * d^-1/2.
// They keep the JAX package's split (flash_attention_bwd.py::_dkv_kernel and
// ::_dq_kernel): a key-major pass accumulates dK and dV, a q-major pass dQ.
// No two blocks write one output row and nothing is added atomically, so the
// gradients are deterministic, and the fp32-output forms are exact partials
// that the ring adds up. Keys at or past kv_eff get zero weight (their dK
// and dV rows are written as 0); q rows at or past nq, and rows that saw no
// key (lse = +inf), get zero weight through P = exp2(s' - lse) = 0.
//
// What bounds them: at D = 64 each score costs 2 * 64 flops per product,
// four products in the dK/dV pass (S^T, dP^T, dV, dK) and three in the dQ
// pass (S, dP, dQ), against one exponential per score in each pass: half
// the exponentials per flop of the forward, so the tensor cores bound them
// even more than they bound the forward (utils/flops.py::roofline_ms).
//
// Design (that of the forward, csrc/flash_fwd_sm90.cuh, with its PTX and
// tensor maps from csrc/sm90_common.cuh):
//   * Warp specialisation. A block's consumer warpgroup owns 64 rows (64
//     keys in the dK/dV pass, 64 q rows in the dQ pass) and a producer warp
//     follows it: 160 threads, two blocks per SM. The owned rows' two tiles
//     (K and V, or Q and dO) are loaded once by TMA; the producer streams
//     the other two (Q and dO, or K and V) in 64-row tiles through a ring
//     of four stages with full/empty mbarriers. All four tiles are
//     [row][64] bf16 under the 128-byte swizzle, so one tile serves as a
//     K-major operand (as K in the forward's Q K^T) and as an MN-major one
//     (as V in P V).
//   * Every product is one wgmma form of the forward: the score-like
//     products (S^T = K Q^T and dP^T = V dO^T, or S = Q K^T and
//     dP = dO V^T) read both operands from shared memory, K-major; the
//     gradient products (dV += P^T dO, dK += dS^T Q, or dQ += dS K) take P
//     or dS from registers, rounded to bf16, and the streamed tile MN-major.
//   * Registers decide the schedule. In every block shape tried (one or
//     two consumer warpgroups, a producer warp or warpgroup, one or two
//     blocks per SM) ptxas held these kernels at 168 registers a thread,
//     -maxrregcount and setmaxnreg notwithstanding, and spilled where more
//     were live. The dQ pass issues the score-like products of tile j
//     together with dQ of tile j - 1 and computes dS of tile j while that
//     runs (dQ, S, dP and the bf16 dS in flight: 140 registers). The dK/dV
//     pass would hold dK, dV, S^T, dP^T and the in-flight bf16 P^T and
//     dS^T at once, which spilled and ran slower; it runs each tile's
//     products and arithmetic in turn (166 registers) and leaves the
//     overlap to the SM's other block. Hence one warp, not the forward's
//     warpgroup, produces: two blocks of 160 threads fit an SM.
//   * The key-major pass needs lse and delta per streamed q row. Their
//     (B, H, Nq) rows are Nq * 4 bytes apart, which TMA refuses where Nq is
//     not a multiple of 4 (the frame layers' 1369 tokens), so the producer
//     warp's 32 lanes copy each stage's slices into shared memory with
//     plain loads (+inf and 0 past nq) and arrive on the stage's barrier.
//     In the q-major pass each consumer thread loads its two rows' values
//     once.
//   * The K/V maps end at kv_eff, so TMA reads zeros past it; a zero key
//     still has P = exp2(-lse) != 0, so those keys are masked explicitly.
//     The Q/dO maps end at nq: zero rows there meet lse = +inf.

#pragma once

#include "sm90_common.cuh"

namespace flash_sm90 {

constexpr int kBwdRows = 64;      // rows a block owns: one warpgroup's
constexpr int kBwdStages = 4;     // stages of streamed 64-row tiles
constexpr int kBwdThreads = 160;  // the consumer warpgroup, the producer warp
constexpr int kBwdBlocksPerSm = 2;
// shared memory, in bytes from a 1024-aligned base: the two owned tiles,
// each stage's two streamed tiles, each stage's lse and delta slices (the
// key-major pass), the barriers
constexpr int kBwdTileBytes = kBwdRows * kRowBytes;
constexpr int kBwdOffStage = 2 * kBwdTileBytes;
constexpr int kBwdOffRows = kBwdOffStage + 2 * kBwdStages * kBwdTileBytes;
constexpr int kBwdOffBar = kBwdOffRows + 2 * kBwdStages * kBwdRows * 4;
constexpr int kBwdSmem = kBwdOffBar + 8 * (1 + 2 * kBwdStages) + 1024;
constexpr int kBwdAcc = kBwdRows / 2;  // accumulators of one 64 x 64 tile

struct BwdParams {
  const float* lse;    // (B, H, Nq), contiguous
  const float* delta;  // (B, H, Nq), contiguous
  void* out0;          // dK (key-major pass) or dQ
  void* out1;          // dV (key-major pass)
  int64_t o0_sb, o0_sn, o0_sh, o1_sb, o1_sn, o1_sh;  // element strides
  int heads, nq, nk, kv_eff;
  int swap_q, swap_k, swap_v, swap_do;  // map dims (D, N, H, B)
  float qscale;  // d^-1/2 * log2(e)
  float scale;   // d^-1/2
};

struct BwdSmem {
  uint32_t base;  // shared-space address, 1024-aligned
  float* rows;    // the lse and delta slices (key-major pass)
  // owned tile i (0: K or Q, 1: V or dO)
  __device__ __forceinline__ uint32_t own(int i) const {
    return base + i * kBwdTileBytes;
  }
  // streamed tile i (0: Q or K, 1: dO or V) of stage st
  __device__ __forceinline__ uint32_t tile(int st, int i) const {
    return base + kBwdOffStage + (2 * st + i) * kBwdTileBytes;
  }
  __device__ __forceinline__ float* lse(int st) const {
    return rows + 2 * st * kBwdRows;
  }
  __device__ __forceinline__ float* delta(int st) const {
    return rows + (2 * st + 1) * kBwdRows;
  }
  // barriers: 0 own_full, 1 + st full, 1 + kBwdStages + st empty
  __device__ __forceinline__ uint32_t own_full() const {
    return base + kBwdOffBar;
  }
  __device__ __forceinline__ uint32_t full(int st) const {
    return base + kBwdOffBar + 8 * (1 + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return base + kBwdOffBar + 8 * (1 + kBwdStages + st);
  }
};

// full_arrivals: 32 where the producer warp's lanes all arrive (one of
// them with the bytes), 1 where one lane loads
__device__ __forceinline__ BwdSmem bwd_setup(uint8_t* raw,
                                             int full_arrivals) {
  const uint32_t base = aligned_base(raw);
  const BwdSmem sm{base, reinterpret_cast<float*>(
                             raw + (base - smem_u32(raw)) + kBwdOffRows)};
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(sm.full(st), full_arrivals);
      mbar_init(sm.empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// This thread's two rows (row0 and row0 + 8) of a 64 x 64 accumulator,
// times `mul`, into the rows below `limit` of a strided (tokens, 64) matrix
// (batch and head already applied): bf16 or fp32.
template <typename OutT>
__device__ __forceinline__ void store_acc(OutT* base, int64_t sn,
                                          const float* acc, float mul,
                                          int row0, int limit, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    OutT* dst = base + static_cast<int64_t>(row) * sn + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r] * mul,
             acc[4 * j + 2 * r + 1] * mul);
  }
}

// P^T and dS^T of one key-major tile, in place: s holds S^T (this thread's
// key rows r = 0, 1 by q columns 8j + 2t + c & 1), dp holds dP^T; lse and
// delta are the tile's q-row slices. Keys that are not live get P = 0.
__device__ __forceinline__ void dkv_probs(float* s, float* dp,
                                          const float* lse,
                                          const float* delta,
                                          const bool* live, float qscale,
                                          int t) {
#pragma unroll
  for (int j = 0; j < kBwdRows / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = 4 * j + c;
      const float pv =
          live[c / 2] ? ex2(fmaf(s[x], qscale, -(c & 1 ? l.y : l.x))) : 0.f;
      dp[x] = pv * (dp[x] - (c & 1 ? dl.y : dl.x));
      s[x] = pv;
    }
  }
}

// dS of one q-major tile, in place in dp: s holds S (this thread's q rows
// r = 0, 1 by keys tile0 + 8j + 2t + c & 1), dp holds dP; lse and delta
// are the two rows' values. Keys at or past kv_eff get P = 0.
__device__ __forceinline__ void dq_probs(const float* s, float* dp,
                                         const float* lse,
                                         const float* delta, int tile0,
                                         int t, int kv_eff, float qscale) {
  const bool whole = tile0 + kBwdRows <= kv_eff;
#pragma unroll
  for (int x = 0; x < kBwdAcc; ++x) {
    const int r = (x / 2) & 1;
    const bool live =
        whole || tile0 + 8 * (x / 4) + 2 * t + (x & 1) < kv_eff;
    const float pv = live ? ex2(fmaf(s[x], qscale, -lse[r])) : 0.f;
    dp[x] = pv * (dp[x] - delta[r]);
  }
}

// --- the key-major pass: dK and dV ------------------------------------------

// One block per (64 keys, batch * head); every key row below nk is
// written. Consumer thread rows: keys key0 and key0 + 8; accumulator
// column 8j + 2t + c of a score tile is q row 8j + 2t + c of the tile.
template <typename OutT>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    flash_bwd_dkv_sm90_kernel(const BwdParams prm,
                              const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do) {
  constexpr int kS = kBwdAcc;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const BwdSmem sm = bwd_setup(smem_raw, 32);
  const int bh = blockIdx.y, b = bh / prm.heads, h = bh % prm.heads;
  const int n0 = blockIdx.x * kBwdRows;
  // a block whose keys are all masked loads nothing and writes zeros
  const int ntiles =
      n0 < prm.kv_eff ? (prm.nq + kBwdRows - 1) / kBwdRows : 0;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= 128) {  // the producer warp
    if (ntiles > 0) {
      const float* lse = prm.lse + static_cast<int64_t>(bh) * prm.nq;
      const float* delta = prm.delta + static_cast<int64_t>(bh) * prm.nq;
      if (lane == 0) {
        mbar_expect_tx(sm.own_full(), 2 * kBwdTileBytes);
        load_rows(sm.own(0), &map_k, sm.own_full(), prm.swap_k, h, n0, b);
        load_rows(sm.own(1), &map_v, sm.own_full(), prm.swap_v, h, n0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kBwdStages;
        mbar_wait(sm.empty(st), ((i / kBwdStages) & 1) ^ 1);
        for (int r = lane; r < kBwdRows; r += 32) {
          const int row = i * kBwdRows + r;
          sm.lse(st)[r] = row < prm.nq ? lse[row] : INFINITY;
          sm.delta(st)[r] = row < prm.nq ? delta[row] : 0.f;
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
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  if (ntiles > 0) {
    const bool live[2] = {key0 < prm.kv_eff, key0 + 8 < prm.kv_eff};
    float s[kS], dp[kS];             // S^T, then P^T; dP^T, then dS^T
    uint32_t p[kS / 2], ds[kS / 2];  // P^T and dS^T as bf16 A operands
    mbar_wait(sm.own_full(), 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kBwdStages;
      mbar_wait(sm.full(st), (i / kBwdStages) & 1);
      wg_fence();
      gemm_ss_nt<kBwdRows>(s, sm.own(0), sm.tile(st, 0));   // S^T = K Q^T
      gemm_ss_nt<kBwdRows>(dp, sm.own(1), sm.tile(st, 1));  // dP^T = V dO^T
      wg_commit();
      wg_wait<0>();
      pin<kS>(s);
      pin<kS>(dp);
      dkv_probs(s, dp, sm.lse(st), sm.delta(st), live, prm.qscale, t);
      pack_acc<kS>(p, s);
      pack_acc<kS>(ds, dp);
      pin<32>(dk);
      pin<32>(dv);
      pin<kS / 2>(p);
      pin<kS / 2>(ds);
      wg_fence();
      gemm_rs_mn<64, kBwdRows>(dv, p, sm.tile(st, 1));   // dV += P^T dO
      gemm_rs_mn<64, kBwdRows>(dk, ds, sm.tile(st, 0));  // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      pin<32>(dk);
      pin<32>(dv);
      pin<kS / 2>(p);
      pin<kS / 2>(ds);
      mbar_arrive(sm.empty(st));
    }
  }
  store_acc(static_cast<OutT*>(prm.out0) + b * prm.o0_sb + h * prm.o0_sh,
            prm.o0_sn, dk, prm.scale, key0, prm.nk, t);
  store_acc(static_cast<OutT*>(prm.out1) + b * prm.o1_sb + h * prm.o1_sh,
            prm.o1_sn, dv, 1.f, key0, prm.nk, t);
}

// --- the q-major pass: dQ ---------------------------------------------------

// One block per (64 q rows, batch * head). Consumer thread rows: q rows
// row0 and row0 + 8; accumulator column 8j + 2t + c of a score tile is key
// 8j + 2t + c of the tile.
template <typename OutT>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    flash_bwd_dq_sm90_kernel(const BwdParams prm,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do) {
  constexpr int kS = kBwdAcc;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const BwdSmem sm = bwd_setup(smem_raw, 1);
  const int bh = blockIdx.y, b = bh / prm.heads, h = bh % prm.heads;
  const int m0 = blockIdx.x * kBwdRows;
  const int ntiles = (prm.kv_eff + kBwdRows - 1) / kBwdRows;

  if (threadIdx.x >= 128) {  // the producer warp's first lane
    if (threadIdx.x == 128 && ntiles > 0) {
      mbar_expect_tx(sm.own_full(), 2 * kBwdTileBytes);
      load_rows(sm.own(0), &map_q, sm.own_full(), prm.swap_q, h, m0, b);
      load_rows(sm.own(1), &map_do, sm.own_full(), prm.swap_do, h, m0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kBwdStages;
        mbar_wait(sm.empty(st), ((j / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(st), 2 * kBwdTileBytes);
        load_rows(sm.tile(st, 0), &map_k, sm.full(st), prm.swap_k, h,
                  j * kBwdRows, b);
        load_rows(sm.tile(st, 1), &map_v, sm.full(st), prm.swap_v, h,
                  j * kBwdRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = m0 + (threadIdx.x / 32) * 16 + lane / 4;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  if (ntiles > 0) {
    float lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int64_t idx = static_cast<int64_t>(bh) * prm.nq + row;
      lse[r] = row < prm.nq ? prm.lse[idx] : INFINITY;
      delta[r] = row < prm.nq ? prm.delta[idx] : 0.f;
    }
    float s[kS], dp[kS];  // S, then P; dP, then dS
    uint32_t ds[kS / 2];  // dS as the bf16 A operand
    mbar_wait(sm.own_full(), 0);
    // tile 0: its scores alone
    mbar_wait(sm.full(0), 0);
    wg_fence();
    gemm_ss_nt<kBwdRows>(s, sm.own(0), sm.tile(0, 0));   // S = Q K^T
    gemm_ss_nt<kBwdRows>(dp, sm.own(1), sm.tile(0, 1));  // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin<kS>(s);
    pin<kS>(dp);
    dq_probs(s, dp, lse, delta, 0, t, prm.kv_eff, prm.qscale);
    pack_acc<kS>(ds, dp);
    int prev = 0;
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kBwdStages;
      mbar_wait(sm.full(st), (j / kBwdStages) & 1);
      pin<32>(dq);
      pin<kS / 2>(ds);
      wg_fence();
      gemm_ss_nt<kBwdRows>(s, sm.own(0), sm.tile(st, 0));
      gemm_ss_nt<kBwdRows>(dp, sm.own(1), sm.tile(st, 1));
      wg_commit();
      gemm_rs_mn<64, kBwdRows>(dq, ds, sm.tile(prev, 0));  // dQ += dS K
      wg_commit();
      wg_wait<1>();  // tile j's scores are done, j - 1's dQ runs on
      pin<kS>(s);
      pin<kS>(dp);
      dq_probs(s, dp, lse, delta, j * kBwdRows, t, prm.kv_eff, prm.qscale);
      wg_wait<0>();
      pin<32>(dq);
      pin<kS / 2>(ds);
      mbar_arrive(sm.empty(prev));
      pack_acc<kS>(ds, dp);
      prev = st;
    }
    pin<32>(dq);
    pin<kS / 2>(ds);
    wg_fence();
    gemm_rs_mn<64, kBwdRows>(dq, ds, sm.tile(prev, 0));
    wg_commit();
    wg_wait<0>();
    pin<32>(dq);
    pin<kS / 2>(ds);
    mbar_arrive(sm.empty(prev));
  }
  store_acc(static_cast<OutT*>(prm.out0) + b * prm.o0_sb + h * prm.o0_sh,
            prm.o0_sn, dq, prm.scale, row0, prm.nq, t);
}

// --- host: the launches -----------------------------------------------------

// The dK/dV pass. st: the 18 element strides (batch, token, head) of q,
// k, v, dout, dk, dv. Returns 0 or an error code (cudaError_t, or
// kErrNoEncoder / kErrMap of csrc/sm90_common.cuh).
template <typename OutT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int64_t batch, int64_t heads, int64_t nq, int64_t nk,
               int64_t kv_eff, const int64_t* st, float qscale, float scale,
               void* stream) {
  if (batch * heads == 0 || nk == 0) return 0;
  const auto kernel = flash_bwd_dkv_sm90_kernel<OutT>;
  // once per output type and library (see the forward's launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  BwdParams prm;
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map(&mq, q, batch, heads, nq, st[0], st[1], st[2],
                     kBwdRows, &prm.swap_q);
  if (!err)
    err = make_map(&mk, k, batch, heads, kv_eff, st[3], st[4], st[5],
                   kBwdRows, &prm.swap_k);
  if (!err)
    err = make_map(&mv, v, batch, heads, kv_eff, st[6], st[7], st[8],
                   kBwdRows, &prm.swap_v);
  if (!err)
    err = make_map(&mdo, dout, batch, heads, nq, st[9], st[10], st[11],
                   kBwdRows, &prm.swap_do);
  if (err) return err;
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.out0 = dk;
  prm.out1 = dv;
  prm.o0_sb = st[12];
  prm.o0_sn = st[13];
  prm.o0_sh = st[14];
  prm.o1_sb = st[15];
  prm.o1_sn = st[16];
  prm.o1_sh = st[17];
  prm.heads = static_cast<int>(heads);
  prm.nq = static_cast<int>(nq);
  prm.nk = static_cast<int>(nk);
  prm.kv_eff = static_cast<int>(kv_eff);
  prm.qscale = qscale;
  prm.scale = scale;
  const dim3 grid(static_cast<unsigned>((nk + kBwdRows - 1) / kBwdRows),
                  static_cast<unsigned>(batch * heads));
  kernel<<<grid, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      prm, mq, mk, mv, mdo);
  return static_cast<int>(cudaGetLastError());
}

// The dQ pass. st: the 15 element strides of q, k, v, dout, dq. Returns as
// launch_dkv.
template <typename OutT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int64_t batch,
              int64_t heads, int64_t nq, int64_t kv_eff, const int64_t* st,
              float qscale, float scale, void* stream) {
  if (batch * heads == 0 || nq == 0) return 0;
  const auto kernel = flash_bwd_dq_sm90_kernel<OutT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  BwdParams prm;
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map(&mq, q, batch, heads, nq, st[0], st[1], st[2],
                     kBwdRows, &prm.swap_q);
  if (!err)
    err = make_map(&mk, k, batch, heads, kv_eff, st[3], st[4], st[5],
                   kBwdRows, &prm.swap_k);
  if (!err)
    err = make_map(&mv, v, batch, heads, kv_eff, st[6], st[7], st[8],
                   kBwdRows, &prm.swap_v);
  if (!err)
    err = make_map(&mdo, dout, batch, heads, nq, st[9], st[10], st[11],
                   kBwdRows, &prm.swap_do);
  if (err) return err;
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.out0 = dq;
  prm.out1 = nullptr;
  prm.o0_sb = st[12];
  prm.o0_sn = st[13];
  prm.o0_sh = st[14];
  prm.o1_sb = prm.o1_sn = prm.o1_sh = 0;
  prm.heads = static_cast<int>(heads);
  prm.nq = static_cast<int>(nq);
  prm.nk = 0;
  prm.kv_eff = static_cast<int>(kv_eff);
  prm.qscale = qscale;
  prm.scale = scale;
  const dim3 grid(static_cast<unsigned>((nq + kBwdRows - 1) / kBwdRows),
                  static_cast<unsigned>(batch * heads));
  kernel<<<grid, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      prm, mq, mk, mv, mdo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_sm90
