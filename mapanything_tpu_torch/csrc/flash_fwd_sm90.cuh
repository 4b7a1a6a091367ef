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

#include <cuda.h>  // CUtensorMap and the CUDA driver API's enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_sm90.cuh"

namespace flash_sm90 {

using flash::wgmma_rs;
using flash::wgmma_ss;

constexpr int kD = 64;          // head dim: one bf16 row is 128 bytes
constexpr int kRowBytes = 128;  // = the swizzle width
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

// --- one warpgroup's pieces -------------------------------------------------

// S (64 x kBN) = Q (this warpgroup's 64 rows) K^T: 4 k-steps of 16 of D,
// each 32 bytes further along the swizzled 128-byte rows.
template <class C>
__device__ __forceinline__ void gemm_qk(float* s, uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<C::kBN>(s, sw128_desc(q_addr + kk * 32, 0, 1024),
                     sw128_desc(k_addr + kk * 32, 0, 1024), kk > 0);
}

// O (64 x kDV) += P (registers) V: kBN / 16 k-steps of 16 keys (2048 bytes).
// With kSumFuse the columns 64-79 come from the ones tile (lbo).
template <class C>
__device__ __forceinline__ void gemm_pv(float* o, const uint32_t* p,
                                        uint32_t v_addr, uint32_t ones_addr) {
  const uint32_t lbo = C::kSumFuse ? ones_addr - v_addr : 0;
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk)
    wgmma_rs<C::kDV>(o, p + 4 * kk, sw128_desc(v_addr + kk * 2048, lbo, 1024));
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
  const uint32_t a = smem_u32(raw);
  Smem<C> sm{(a + 1023u) & ~1023u};
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
    uint8_t* ones = raw + (sm.ones() - a);
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

// --- host: tensor maps and the launch ---------------------------------------

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
// blocks. Returns 0 or an error code (cudaError_t or the two above).
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
