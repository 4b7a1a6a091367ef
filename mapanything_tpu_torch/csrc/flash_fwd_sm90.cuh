// The flash-attention forward for Hopper (sm_90a) on TMA and wgmma: the
// kernel template behind csrc/flash_attn_fwd_sm90.cu (the main path's three
// entries) and csrc/flash_attn_fwd_probes.cu (its tuning probes).
//
// What it computes: softmax(Q K^T * d^-1/2) V at D = 64, bf16 in, with one
// of three epilogues (the bf16 output; the output and its base-2 lse; the
// ring's unnormalised fp32 accumulator with m and l). Keys at index >=
// kv_eff are excluded; a row that sees no key is written as 0 (lse +inf;
// stats m = -inf, l = 0).
//
// What bounds it: at D = 64 each score costs 4 * 64 = 256 tensor-core flops
// (Q K^T and P V) and one exp2 on the special-function unit. 989 TFLOP/s /
// 256 = 3.9e12 scores/s, about what 132 SMs x 16 ex2 per clock give at the
// 1.83 GHz that rate assumes: the exponentials cost as much as both
// products, so the kernel is bound by operations and the softmax has to run
// while the tensor cores work on another tile.
//
// Design:
//   * Warp specialisation. Warpgroup 0 is the producer: one thread issues
//     TMA loads (cp.async.bulk.tensor, 4-D maps over (D, H, N, B) with the
//     caller's strides, 128-byte swizzle) of Q once per work item and of K
//     and V per key tile into a ring of kStages stages, each signalled by an
//     mbarrier (full) and released by the consumers (empty). The producer
//     keeps 24 registers (setmaxnreg); the consumers take the rest.
//   * kWG consumer warpgroups, 64 query rows each (a block owns 64 * kWG
//     rows). S = Q K^T is one wgmma.m64nNk16 per 16 of D with both operands
//     in shared memory; P stays in registers as the A operand of
//     O += P V (wgmma's register-A form, V read MN-major).
//   * Overlap inside a warpgroup: the Q K^T of tile j is issued together
//     with the P V of tile j-1, and the softmax of tile j runs while that
//     P V is still in flight. Optionally (kPingPong) two consumer
//     warpgroups take turns at issuing their products (named barriers), so
//     one's softmax runs under the other's products.
//   * The K/V maps have kv_eff as their token extent: TMA fills every key
//     at or past it with zeros (so a pad row's garbage cannot reach the sum
//     as 0 * NaN), and the scores of those keys are set to -inf.
//   * A block walks a list of work items (head, 64 * kWG query rows): one
//     item by default, kHeads consecutive heads of one q tile
//     (heads_per_block), or a persistent grid; the producer runs ahead into
//     the next item while the consumers finish the last.
//   * The online softmax keeps fp32 running max and sum in base 2 with the
//     guards of the mma.sync kernel (m_use: a row whose max is still -inf
//     subtracts 0). P is rounded to bf16 for the tensor cores.
//
// Variants for the probes (csrc/flash_attn_fwd_probes.cu): the softmax
// without running max (kNoMax) or without exponentials (kNoExp: P = S', the
// output unnormalised), exp2 on packed bf16 pairs (kExpBf16), the row sum
// taken by the P V product through a ones column (kSumFuse, V padded to 80
// columns in shared memory), tile shapes and stage counts, and the kernel
// without warp specialisation (kWarpSpec = false: one warpgroup whose first
// thread also issues the loads).

#pragma once

#include <algorithm>

#include "sm90_common.cuh"

namespace flash_sm90 {

constexpr int kProducerRegs = 24;

enum Epilogue { kOut = 0, kOutLse = 1, kStats = 2 };
enum Softmax { kOnline = 0, kNoMax = 1, kNoExp = 2 };

template <int kMode_, int kWG_, int kBN_, int kStages_,
          int kSoftmax_ = kOnline, bool kExpBf16_ = false,
          bool kSumFuse_ = false, bool kPingPong_ = false,
          bool kWarpSpec_ = true>
struct Config {
  static constexpr int kMode = kMode_;
  static constexpr int kWG = kWG_;  // consumer warpgroups
  static constexpr int kBM = 64 * kWG_;
  static constexpr int kBN = kBN_;
  static constexpr int kStages = kStages_;
  static constexpr int kSoftmax = kSoftmax_;
  static constexpr bool kExpBf16 = kExpBf16_;
  static constexpr bool kSumFuse = kSumFuse_;
  static constexpr bool kPingPong = kPingPong_;
  static constexpr bool kWarpSpec = kWarpSpec_;
  static constexpr int kDV = kSumFuse ? 80 : kD;  // N of the P V product
  static constexpr int kThreads = (kWG + (kWarpSpec ? 1 : 0)) * 128;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 240;
  // shared memory, in bytes from a 1024-aligned base (the swizzle atom)
  static constexpr int kQBytes = kBM * kRowBytes;
  static constexpr int kKVBytes = kBN * kRowBytes;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffOnes = kOffV + kStages * kKVBytes;
  static constexpr int kOffBar = kOffOnes + (kSumFuse ? kKVBytes : 0);
  static constexpr int kSmem = kOffBar + 8 * (2 + 2 * kStages) + 1024;

  static_assert(kBN % 16 == 0 && kBN <= 256, "key tile");
  static_assert(kWG >= 1 && kWG <= 3, "consumer warpgroups");
  static_assert(kWarpSpec || kWG == 1, "one warpgroup without a producer");
  static_assert(!kPingPong || kWG == 2, "ping-pong takes two warpgroups");
  static_assert(!(kSumFuse && kSoftmax == kNoExp), "no row sum to fuse");
};

struct Params {
  void* o;       // bf16 (B, Nq, H, 64), or the fp32 accumulator (kStats)
  float* lse;    // (B, H, Nq) (kOutLse), or the stats' m (B, Nq, H)
  float* l_out;  // the stats' l (B, Nq, H)
  int64_t o_sb, o_sn, o_sh;  // element strides of o
  int heads, nq, kv_eff, qtiles, total;  // total = B * H * qtiles items
  int heads_per_block;  // > 1: that many heads of one q tile per block
  int persistent;       // 1: block i takes items i, i + grid, ...
  int swap_q, swap_k, swap_v;  // map dims (D, N, H, B) instead of (D, H, N, B)
  float qscale;  // d^-1/2 * log2(e)
};

// --- one warpgroup's pieces -------------------------------------------------

// S (64 x kBN) = Q (this warpgroup's 64 rows) K^T.
template <class C>
__device__ __forceinline__ void gemm_qk(float* s, uint32_t q_addr,
                                        uint32_t k_addr) {
  gemm_ss_nt<C::kBN>(s, q_addr, k_addr);
}

// O (64 x kDV) += P (registers) V. With kSumFuse the columns 64-79 come
// from the ones tile (lbo).
template <class C>
__device__ __forceinline__ void gemm_pv(float* o, const uint32_t* p,
                                        uint32_t v_addr, uint32_t ones_addr) {
  gemm_rs_mn<C::kDV, C::kBN>(o, p, v_addr,
                             C::kSumFuse ? ones_addr - v_addr : 0);
}

// The softmax of one score tile, in place: masks keys >= kv_eff, updates
// the running max m and sum l of this thread's two rows (r = 0: row
// lane/4, r = 1: row lane/4 + 8) and returns the rescale factors in alpha.
// s[4j + c] holds key 8j + 2t + (c & 1) of row c / 2 (t = lane % 4). With
// kExpBf16 the exponentials are left to pack_p; m_use keeps what they
// subtract.
template <class C>
__device__ __forceinline__ void softmax(float* s, float* m, float* l,
                                        float* alpha, float* m_use,
                                        float qscale, int key0, int kv_eff,
                                        int t) {
  constexpr int kS = C::kBN / 2;
  if (key0 + C::kBN > kv_eff) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (key >= kv_eff) s[i] = C::kSoftmax == kNoExp ? 0.f : -INFINITY;
    }
  }
  if constexpr (C::kSoftmax == kNoExp) {  // P = S': the products alone
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] *= qscale;
    alpha[0] = alpha[1] = 1.f;
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mu = 0.f;
    alpha[r] = 1.f;
    if (C::kSoftmax == kOnline) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kS / 4; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * qscale);
      mu = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m[r] - mu);
      m[r] = m_new;
    }
    m_use[r] = mu;
    float rs = 0.f;
    if (!C::kExpBf16) {
#pragma unroll
      for (int j = 0; j < kS / 4; ++j) {
        s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], qscale, -mu));
        s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], qscale, -mu));
        rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
    }
    if (!C::kSumFuse) l[r] = l[r] * alpha[r] + rs;
  }
}

// P as the A operand: p[i] = (s[2i], s[2i + 1]) in bf16, row i & 1. With
// kExpBf16 the exponentials are taken here, on packed bf16 pairs.
template <class C>
__device__ __forceinline__ void pack_p(uint32_t* p, const float* s,
                                       float* l, const float* m_use,
                                       float qscale) {
#pragma unroll
  for (int i = 0; i < C::kBN / 4; ++i) {
    if (C::kExpBf16) {
      const float mu = m_use[i & 1];
      p[i] = ex2_bf16x2(pack_bf16(fmaf(s[2 * i], qscale, -mu),
                                  fmaf(s[2 * i + 1], qscale, -mu)));
      if (!C::kSumFuse) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&p[i]);
        l[i & 1] += __low2float(v) + __high2float(v);
      }
    } else {
      p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
  }
}

template <class C>
__device__ __forceinline__ void rescale(float* o, const float* alpha) {
  if constexpr (C::kSoftmax == kOnline) {
#pragma unroll
    for (int i = 0; i < C::kDV / 2; ++i) o[i] *= alpha[(i / 2) & 1];
  }
}

// Writes this thread's two rows of one work item.
template <class C>
__device__ __forceinline__ void epilogue(const Params& prm, float* o,
                                         const float* m, const float* l,
                                         int b, int h, int row0, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    if constexpr (C::kSumFuse) {  // column 64 of O: t == 0 holds o[32 + 2r]
      li = __shfl_sync(0xffffffffu, o[32 + 2 * r], lane & ~3);
    } else {
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
    }
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= prm.nq) continue;
    const int64_t off = b * prm.o_sb + row * prm.o_sn + h * prm.o_sh + 2 * t;
    if (C::kMode == kStats) {
      float* dst = static_cast<float*>(prm.o) + off;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (t == 0) {
        const int64_t idx =
            (static_cast<int64_t>(b) * prm.nq + row) * prm.heads + h;
        prm.lse[idx] = m[r];
        prm.l_out[idx] = li;
      }
    } else {
      const float inv =
          C::kSoftmax == kNoExp ? 1.f : (li == 0.f ? 0.f : 1.f / li);
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(prm.o) + off;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      if (C::kMode == kOutLse && t == 0)
        prm.lse[(static_cast<int64_t>(b) * prm.heads + h) * prm.nq + row] =
            li == 0.f ? INFINITY : m[r] + log2f(li);
    }
  }
}

// --- the work list ----------------------------------------------------------

struct Work {
  int first, step, count;
};

__device__ __forceinline__ Work block_work(const Params& prm) {
  const int bx = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  if (prm.persistent) return {bx, grid, (prm.total - bx + grid - 1) / grid};
  const int qt = bx % prm.qtiles;
  const int bh0 = (bx / prm.qtiles) * prm.heads_per_block;
  const int bh_total = prm.total / prm.qtiles;
  return {bh0 * prm.qtiles + qt, prm.qtiles,
          min(prm.heads_per_block, bh_total - bh0)};
}

struct Item {
  int b, h, m0;
};

template <class C>
__device__ __forceinline__ Item item_of(const Params& prm, int w) {
  const int bh = w / prm.qtiles;
  return {bh / prm.heads, bh % prm.heads, (w % prm.qtiles) * C::kBM};
}

// --- the kernels ------------------------------------------------------------

template <class C>
struct Smem {
  uint32_t base;  // shared-space address, 1024-aligned
  __device__ __forceinline__ uint32_t q(int wg) const {
    return base + wg * 64 * kRowBytes;
  }
  __device__ __forceinline__ uint32_t k(int st) const {
    return base + C::kOffK + st * C::kKVBytes;
  }
  __device__ __forceinline__ uint32_t v(int st) const {
    return base + C::kOffV + st * C::kKVBytes;
  }
  __device__ __forceinline__ uint32_t ones() const {
    return base + C::kOffOnes;
  }
  __device__ __forceinline__ uint32_t bar(int i) const {
    return base + C::kOffBar + 8 * i;
  }
  // barriers: 0 q_full, 1 q_empty, 2 + st full, 2 + kStages + st empty
  __device__ __forceinline__ uint32_t q_full() const { return bar(0); }
  __device__ __forceinline__ uint32_t q_empty() const { return bar(1); }
  __device__ __forceinline__ uint32_t full(int st) const {
    return bar(2 + st);
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return bar(2 + C::kStages + st);
  }
};

template <class C>
__device__ __forceinline__ Smem<C> setup_smem(uint8_t* raw) {
  Smem<C> sm{aligned_base(raw)};
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    mbar_init(sm.q_empty(), C::kWG * 128);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), C::kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C::kSumFuse) {  // column 64 of every key row: 1, written swizzled
    uint8_t* ones = raw + (sm.ones() - smem_u32(raw));
    for (int i = threadIdx.x; i < C::kBN * kRowBytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(ones)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int r = threadIdx.x; r < C::kBN; r += blockDim.x)
      *reinterpret_cast<uint16_t*>(ones + r * kRowBytes + (r & 7) * 16) =
          0x3F80u;  // bf16 1.0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// One consumer warpgroup's work on one item: the overlapped main loop.
// `t` counts key tiles across items (stage t % kStages, its fill t /
// kStages), `it` the items.
template <class C>
__device__ __forceinline__ void consume(const Params& prm, const Smem<C>& sm,
                                        Item item, int cw, int& t, int it) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int nblk = (prm.kv_eff + C::kBN - 1) / C::kBN;
  const uint32_t q_addr = sm.q(cw);
  auto sched_sync = [&] {
    if (C::kPingPong) bar_sync(1 + cw, 256);
  };
  auto sched_arrive = [&] {
    if (C::kPingPong) bar_arrive(1 + (cw ^ 1), 256);
  };

  float o[C::kDV / 2];
#pragma unroll
  for (int i = 0; i < C::kDV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2], m_use[2];
  float s[C::kBN / 2];
  uint32_t p[C::kBN / 4];

  mbar_wait(sm.q_full(), it & 1);
  if (nblk == 0) {
    mbar_arrive(sm.q_empty());
  } else {
    int st = t % C::kStages;
    mbar_wait(sm.full(st), (t / C::kStages) & 1);
    sched_sync();
    wg_fence();
    gemm_qk<C>(s, q_addr, sm.k(st));
    wg_commit();
    sched_arrive();
    wg_wait<0>();
    pin<C::kBN / 2>(s);
    if (nblk == 1) mbar_arrive(sm.q_empty());
    softmax<C>(s, m, l, alpha, m_use, prm.qscale, 0, prm.kv_eff, lane % 4);
    pack_p<C>(p, s, l, m_use, prm.qscale);
    int prev = st;
    ++t;
    for (int j = 1; j < nblk; ++j, ++t) {
      st = t % C::kStages;
      mbar_wait(sm.full(st), (t / C::kStages) & 1);
      sched_sync();
      pin<C::kDV / 2>(o);
      pin<C::kBN / 4>(p);
      wg_fence();
      gemm_qk<C>(s, q_addr, sm.k(st));
      wg_commit();
      gemm_pv<C>(o, p, sm.v(prev), sm.ones());
      wg_commit();
      sched_arrive();
      wg_wait<1>();  // Q K^T of tile j is done, P V of j - 1 may run on
      pin<C::kBN / 2>(s);
      if (j == nblk - 1) mbar_arrive(sm.q_empty());
      softmax<C>(s, m, l, alpha, m_use, prm.qscale, j * C::kBN, prm.kv_eff,
                 lane % 4);
      wg_wait<0>();
      pin<C::kDV / 2>(o);
      pin<C::kBN / 4>(p);
      mbar_arrive(sm.empty(prev));
      rescale<C>(o, alpha);
      pack_p<C>(p, s, l, m_use, prm.qscale);
      prev = st;
    }
    sched_sync();
    pin<C::kDV / 2>(o);
    pin<C::kBN / 4>(p);
    wg_fence();
    gemm_pv<C>(o, p, sm.v(prev), sm.ones());
    wg_commit();
    sched_arrive();
    wg_wait<0>();
    pin<C::kDV / 2>(o);
    pin<C::kBN / 4>(p);
    mbar_arrive(sm.empty(prev));
  }
  epilogue<C>(prm, o, m, l, item.b, item.h, item.m0 + cw * 64 + warp * 16,
              lane);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_sm90_kernel(const Params prm,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<C> sm = setup_smem<C>(smem_raw);
  const Work work = block_work(prm);
  const int nblk = (prm.kv_eff + C::kBN - 1) / C::kBN;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer
    if constexpr (C::kWG > 1)  // one warpgroup keeps its registers
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (threadIdx.x == 0) {
      int t = 0;
      for (int i = 0; i < work.count; ++i) {
        const Item item = item_of<C>(prm, work.first + i * work.step);
        mbar_wait(sm.q_empty(), (i & 1) ^ 1);
        mbar_expect_tx(sm.q_full(), C::kQBytes);
        load_rows(sm.q(0), &map_q, sm.q_full(), prm.swap_q, item.h, item.m0,
                  item.b);
        for (int j = 0; j < nblk; ++j, ++t) {
          const int st = t % C::kStages;
          mbar_wait(sm.empty(st), ((t / C::kStages) & 1) ^ 1);
          mbar_expect_tx(sm.full(st), 2 * C::kKVBytes);
          load_rows(sm.k(st), &map_k, sm.full(st), prm.swap_k, item.h,
                    j * C::kBN, item.b);
          load_rows(sm.v(st), &map_v, sm.full(st), prm.swap_v, item.h,
                    j * C::kBN, item.b);
        }
      }
    }
  } else {  // the consumers
    if constexpr (C::kWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::kConsumerRegs));
    const int cw = wg - 1;
    if (C::kPingPong && cw == 1) bar_arrive(1, 256);  // warpgroup 0 first
    int t = 0;
    for (int i = 0; i < work.count; ++i)
      consume<C>(prm, sm, item_of<C>(prm, work.first + i * work.step), cw, t,
                 i);
  }
}

// Step (a) of the design, kept as a probe: one warpgroup, no producer, no
// overlap. Its thread 0 issues the loads kStages tiles ahead; each tile's
// Q K^T, softmax and P V run in order.
template <class C>
__global__ void __launch_bounds__(128, 1)
    flash_fwd_sm90_simple_kernel(const Params prm,
                                 const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<C> sm = setup_smem<C>(smem_raw);
  const Work work = block_work(prm);
  const int nblk = (prm.kv_eff + C::kBN - 1) / C::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int t = 0;
  for (int i = 0; i < work.count; ++i) {
    const Item item = item_of<C>(prm, work.first + i * work.step);
    auto issue = [&](int j, int tile) {
      const int st = tile % C::kStages;
      mbar_expect_tx(sm.full(st), 2 * C::kKVBytes);
      load_rows(sm.k(st), &map_k, sm.full(st), prm.swap_k, item.h,
                j * C::kBN, item.b);
      load_rows(sm.v(st), &map_v, sm.full(st), prm.swap_v, item.h,
                j * C::kBN, item.b);
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.q_full(), C::kQBytes);
      load_rows(sm.q(0), &map_q, sm.q_full(), prm.swap_q, item.h, item.m0,
                item.b);
      for (int j = 0; j < min(C::kStages, nblk); ++j) issue(j, t + j);
    }
    float o[C::kDV / 2];
#pragma unroll
    for (int c = 0; c < C::kDV / 2; ++c) o[c] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float alpha[2], m_use[2];
    float s[C::kBN / 2];
    uint32_t p[C::kBN / 4];
    mbar_wait(sm.q_full(), i & 1);
    for (int j = 0; j < nblk; ++j, ++t) {
      const int st = t % C::kStages;
      mbar_wait(sm.full(st), (t / C::kStages) & 1);
      wg_fence();
      gemm_qk<C>(s, sm.q(0), sm.k(st));
      wg_commit();
      wg_wait<0>();
      pin<C::kBN / 2>(s);
      softmax<C>(s, m, l, alpha, m_use, prm.qscale, j * C::kBN, prm.kv_eff,
                 lane % 4);
      rescale<C>(o, alpha);
      pack_p<C>(p, s, l, m_use, prm.qscale);
      pin<C::kDV / 2>(o);
      pin<C::kBN / 4>(p);
      wg_fence();
      gemm_pv<C>(o, p, sm.v(st), sm.ones());
      wg_commit();
      wg_wait<0>();
      pin<C::kDV / 2>(o);
      pin<C::kBN / 4>(p);
      bar_sync(1, 128);  // every warp is done with stage st
      if (threadIdx.x == 0 && j + C::kStages < nblk) issue(j + C::kStages, t);
    }
    epilogue<C>(prm, o, m, l, item.b, item.h, item.m0 + warp * 16, lane);
    bar_sync(1, 128);  // Q is free for the next item
  }
}

// --- host: the launch -----------------------------------------------------

template <class C>
constexpr auto kernel_of() {
  if constexpr (C::kWarpSpec)
    return flash_fwd_sm90_kernel<C>;
  else
    return flash_fwd_sm90_simple_kernel<C>;
}

// Launches configuration C. st: the 12 element strides (batch, token,
// head) of q, k, v, o. heads_per_block > 1 gives each block that many heads
// of one q tile; persistent_blocks > 0 a persistent grid of that many
// blocks. Returns 0 or an error code (cudaError_t, or kErrNoEncoder /
// kErrMap of csrc/sm90_common.cuh).
template <class C>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* l_out, int64_t batch, int64_t heads, int64_t nq,
           int64_t kv_eff, const int64_t* st, float qscale,
           int heads_per_block, int persistent_blocks, void* stream) {
  if (batch * heads == 0 || nq == 0) return 0;
  const auto kernel = kernel_of<C>();
  // once per configuration and library: ops/_build.py compiles with
  // -fno-gnu-unique, so the main and the probe library, which instantiate
  // the same configuration, each keep their own copy of this static
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params prm;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, batch, heads, nq, st[0], st[1], st[2], C::kBM,
                     &prm.swap_q);
  if (!err)
    err = make_map(&mk, k, batch, heads, kv_eff, st[3], st[4], st[5], C::kBN,
                   &prm.swap_k);
  if (!err)
    err = make_map(&mv, v, batch, heads, kv_eff, st[6], st[7], st[8], C::kBN,
                   &prm.swap_v);
  if (err) return err;
  prm.o = o;
  prm.lse = lse;
  prm.l_out = l_out;
  prm.o_sb = st[9];
  prm.o_sn = st[10];
  prm.o_sh = st[11];
  prm.heads = static_cast<int>(heads);
  prm.nq = static_cast<int>(nq);
  prm.kv_eff = static_cast<int>(kv_eff);
  prm.qtiles = static_cast<int>((nq + C::kBM - 1) / C::kBM);
  prm.total = static_cast<int>(batch * heads) * prm.qtiles;
  prm.heads_per_block = heads_per_block > 1 ? heads_per_block : 1;
  prm.persistent = persistent_blocks > 0;
  prm.qscale = qscale;
  const int bh = static_cast<int>(batch * heads);
  const int groups = (bh + prm.heads_per_block - 1) / prm.heads_per_block;
  const int grid = prm.persistent ? std::min(persistent_blocks, prm.total)
                                  : prm.qtiles * groups;
  kernel<<<grid, C::kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      prm, mq, mk, mv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_sm90
