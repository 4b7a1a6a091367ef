// The mma.sync flash-attention forward (sm_90a, pre-Hopper tensor-core
// path): softmax(Q K^T * d^-1/2) V, optionally with the per-row
// log-sum-exp that the backward needs, or as the unnormalised partial state
// that the ring merges.
//
// This was the main path's forward until the TMA/wgmma kernel of
// csrc/flash_fwd_sm90.cuh replaced it. It stays as the baseline that kernel
// is timed against: its entries (flash_attn_fwd_mma, flash_attn_fwd_lse_mma,
// flash_attn_fwd_stats_mma) live in the probe library and nothing on the
// main path calls them.
//
// Replaces the two serving-path Pallas kernels of the JAX package:
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_1pass_T (kv <= 2816)
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_T       (online, kv > 2816)
// with the lse output (entry point flash_attn_fwd_lse), the two training
// forwards:
//   mapanything_tpu/ops/flash_attention_bwd.py::_fwd_with_lse_kernel_1pass_T
//   mapanything_tpu/ops/flash_attention_bwd.py::_fwd_with_lse_kernel_T
// and with the stats epilogue (entry point flash_attn_fwd_stats), the ring
// attention's per-shard kernel:
//   mapanything_tpu/ops/ring_attention.py::_flash_stats_kernel
// Each block owns a 64-row q tile and loops over 64-key K/V tiles with an
// online softmax (fp32 running max and sum, base 2); a sequence that fits
// one pass is simply the short loop.
//
// What bounds it on an H100: at D = 64 attention does 4*D = 256 flops per
// byte of Q/K/V/O it moves (kv of a few thousand keys), near the card's
// ~295 flop/byte ridge for bf16 and far above it for the CUDA cores, so it
// is compute bound. The design keeps the S and P tiles on chip (the score
// matrix never reaches device memory) and runs both products on the tensor
// cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate). Four warps per
// block, 16 q rows each; Q stays in registers as A fragments, K and V tiles
// come from shared memory through ldmatrix (V transposed by ldmatrix.trans),
// and the S accumulators are repacked in registers as the A operand of the
// P V product, so P never touches shared memory. Rows of 72 bf16 keep the
// ldmatrix reads free of bank conflicts. S stays fp32; P is rounded to bf16
// for the tensor cores, as the JAX package does. Inputs are bf16 only; the
// wrapper rejects anything else.
//
// The lse is base 2 in the scaled-logit domain: lse = m + log2(l), where m
// is the running max of s * d^-1/2 * log2(e) and l the sum of exp2(s' - m),
// so the backward recovers P = exp2(s' - lse). A row that sees no key
// (l == 0) writes lse = +inf, which makes that P exactly 0.
//
// The stats epilogue writes the fp32 accumulator without dividing by l,
// and m and l themselves, in the JAX package's conventions: acc / l is the
// attention output, and a row that sees no key keeps m = -inf and l = 0
// (the ring's merge guards exactly that pair; it is not the lse's +inf).
// V may be the same tensor as K (the ring's lse backward sums P K): K and V
// are read through their own strides.
//
// It has no copy/compute overlap inside a block (plain 16-byte loads
// bracketed by __syncthreads) and issues both products through mma.sync.
//
// Layout: q (B, Nq, H, 64), k and v (B, Nk, H, 64), read through their
// (batch, token, head) strides with unit stride along D; o is written the
// same way (bf16, or fp32 for the stats), lse as a contiguous (B, H, Nq)
// fp32 tensor, the stats m and l as contiguous (B, Nq, H) fp32 tensors.
// Keys at index >= kv_eff are excluded (the aligned-token n_valid mask, and
// the ragged tail of a ring shard): they are loaded as zeros and their
// scores set to -inf. A row that sees no key is written as 0.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// What the epilogue writes.
enum Epilogue { kOut = 0, kOutLse = 1, kStats = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* v,  // may alias k
                         void* __restrict__ o,
                         float* __restrict__ lse,  // or the stats' m
                         float* __restrict__ l_out,
                         int64_t q_sb, int64_t q_sn, int64_t q_sh,
                         int64_t k_sb, int64_t k_sn, int64_t k_sh,
                         int64_t v_sb, int64_t v_sn, int64_t v_sh,
                         int64_t o_sb, int64_t o_sn, int64_t o_sh,
                         int heads, int nq, int kv_eff, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kHPitch];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kTile;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this thread's rows in the warp's 16-row slice: lane/4 and lane/4 + 8;
  // its columns in each 8-wide n-tile: (lane%4)*2 and (lane%4)*2 + 1

  load_tile_bf16(qs, qb, q_sn, m0, nq);
  __syncthreads();
  uint32_t qf[4][4];  // A fragments of Q, one per 16-wide slice of D
  load_a_frags(qf, qs, warp, lane);

  float acc[8][4];  // O: 8 n-tiles of 8 dims
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int n0 = 0; n0 < kv_eff; n0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16(ks, kb, k_sn, n0, kv_eff);
    load_tile_bf16(vs, vb, v_sn, n0, kv_eff);
    __syncthreads();

    float s[8][4];  // S = Q K^T: 8 n-tiles of 8 keys
    mma_a_times_tile_t(s, qf, ks, lane);

    // base-2 logits, keys past kv_eff masked
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = n0 + j * 8 + (lane % 4) * 2 + (c & 1);
        s[j][c] = key < kv_eff ? s[j][c] * qscale : -INFINITY;
      }

    // online softmax; row r of this thread holds c = 2r, 2r+1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
        const float p0 = exp2f(s[j][2 * r] - m_use);
        const float p1 = exp2f(s[j][2 * r + 1] - m_use);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        l[r] += p0 + p1;
      }
      m[r] = m_new;
    }

    // O += P V: P stays in registers as the A operand
    mma_acc_times_tile(acc, s, vs, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = m0 + warp * 16 + lane / 4 + r * 8;
    if (row >= nq) continue;
    if (kMode == kStats) {
      store_row(static_cast<float*>(o) + b * o_sb + h * o_sh, o_sn, row, acc,
                r, 1.f, lane);
      if (lane % 4 == 0) {
        const int64_t idx = (static_cast<int64_t>(b) * nq + row) * heads + h;
        lse[idx] = m[r];
        l_out[idx] = li;
      }
    } else {
      const float inv = (li == 0.f) ? 0.f : 1.f / li;
      store_row(static_cast<__nv_bfloat16*>(o) + b * o_sb + h * o_sh, o_sn,
                row, acc, r, inv, lane);
      if (kMode == kOutLse && lane % 4 == 0)
        lse[static_cast<int64_t>(blockIdx.y) * nq + row] =
            (li == 0.f) ? INFINITY : m[r] + log2f(li);
    }
  }
}

template <int kMode>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* l_out, int64_t batch, int64_t heads, int64_t nq,
           int64_t kv_eff, const int64_t* st, float qscale, void* stream) {
  const dim3 grid(static_cast<unsigned>((nq + kTile - 1) / kTile),
                  static_cast<unsigned>(batch * heads));
  flash_fwd_mma_kernel<kMode><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, lse, l_out, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      static_cast<int>(heads), static_cast<int>(nq),
      static_cast<int>(kv_eff), qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes; the arguments of
// csrc/flash_attn_fwd_sm90.cu's entries of the same names without "_mma".
//   q, k, v: bfloat16; o: bfloat16 (flash_attn_fwd, flash_attn_fwd_lse) or
//     the fp32 unnormalised accumulator (flash_attn_fwd_stats_mma)
//   lse: (batch, heads, nq) float32, contiguous (flash_attn_fwd_lse_mma only)
//   m, l: (batch, nq, heads) float32, contiguous (..._stats_mma only)
//   strides: 12 element strides, (batch, token, head) for q, k, v, o
//   qscale: softmax scale times log2(e)
// Each returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd_mma(const void* q, const void* k,
                                  const void* v, void* o, int64_t batch,
                                  int64_t heads, int64_t nq, int64_t kv_eff,
                                  const int64_t* st, float qscale,
                                  void* stream) {
  return launch<kOut>(q, k, v, o, nullptr, nullptr, batch, heads, nq, kv_eff,
                      st, qscale, stream);
}

extern "C" int flash_attn_fwd_lse_mma(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int64_t batch, int64_t heads,
                                      int64_t nq, int64_t kv_eff,
                                      const int64_t* st, float qscale,
                                      void* stream) {
  return launch<kOutLse>(q, k, v, o, static_cast<float*>(lse), nullptr, batch,
                         heads, nq, kv_eff, st, qscale, stream);
}

extern "C" int flash_attn_fwd_stats_mma(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int64_t batch, int64_t heads,
                                    int64_t nq, int64_t kv_eff,
                                    const int64_t* st, float qscale,
                                    void* stream) {
  return launch<kStats>(q, k, v, acc, static_cast<float*>(m),
                        static_cast<float*>(l), batch, heads, nq, kv_eff, st,
                        qscale, stream);
}
