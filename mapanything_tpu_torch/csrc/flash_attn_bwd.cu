// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ from the saved
// output's per-row log-sum-exp, never materialising the (Nq, Nk) matrices.
//
// Replaces the two Pallas backward kernels of the JAX package:
//   mapanything_tpu/ops/flash_attention_bwd.py::_dkv_kernel  (flash_attn_bwd_dkv)
//   mapanything_tpu/ops/flash_attention_bwd.py::_dq_kernel   (flash_attn_bwd_dq)
// with the same split: a key-major pass accumulates dK and dV, a q-major
// pass accumulates dQ, so no two blocks write one output row and no atomics
// are needed (the gradients are deterministic).
//
// The formulas, with s' = q.k * d^-1/2 * log2(e) and the forward's base-2
// lse, delta = rowsum(dO * O) (computed by the caller):
//   P = exp2(s' - lse),  dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),
//   dK = dS^T Q * d^-1/2,  dQ = dS K * d^-1/2.
//
// What bounds them on an H100: each key tile of the dK/dV pass does four
// 64-deep products per q tile it streams (S^T, dP^T, dV, dK), the dQ pass
// three; at D = 64 both are compute bound like the forward. The design
// mirrors the forward (csrc/flash_attn_fwd.cu): four warps, each owning 16
// rows, mma.sync m16n8k16 with bf16 operands and fp32 accumulators, the
// row-owner's operands (K and V here, Q and dO in the dQ pass) held as A
// fragments in registers for the whole loop, the streamed tiles read from
// shared memory through ldmatrix / ldmatrix.trans, and P and dS repacked from
// accumulators into A fragments in registers, so neither touches shared
// memory. The dK/dV pass computes S^T = K Q^T directly rather than S, so the
// key rows are the accumulator rows. S, P and dS stay fp32 until they are
// rounded to bf16 as tensor-core operands, as the JAX kernels round them.
//
// None of the TPU layout tricks is carried over (transposed outputs, q^T /
// dO^T streamed from HBM, unmasked padded tails): the kernels read the
// (batch, token, head) strides of q, k, v and dO directly (unit stride
// along D), mask keys at or past kv_eff explicitly (their dK/dV rows are
// written as 0), and give q rows past nq zero weight through lse = +inf.
// A row that saw no key carries lse = +inf from the forward, so its P is 0.
//
// Layout: q, dO, dQ (B, Nq, H, 64); k, v, dK, dV (B, Nk, H, 64), bf16;
// lse and delta contiguous (B, H, Nq) fp32.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// One block per (64-key tile, batch * head). Each warp owns 16 key rows;
// the loop streams 64-row tiles of Q and dO.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         int64_t q_sb, int64_t q_sn, int64_t q_sh,
                         int64_t k_sb, int64_t k_sn, int64_t k_sh,
                         int64_t v_sb, int64_t v_sn, int64_t v_sh,
                         int64_t do_sb, int64_t do_sn, int64_t do_sh,
                         int64_t dk_sb, int64_t dk_sn, int64_t dk_sh,
                         int64_t dv_sb, int64_t dv_sn, int64_t dv_sh,
                         int heads, int nq, int nk, int kv_eff, float qscale,
                         float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kHPitch];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lse_bh = lse + static_cast<int64_t>(blockIdx.y) * nq;
  const float* delta_bh = delta + static_cast<int64_t>(blockIdx.y) * nq;

  float dk_acc[8][4];  // this warp's 16 keys x 64 dims
  float dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  if (n0 < kv_eff) {
    // this block's K and V rows as A fragments (keys past kv_eff are zeros)
    load_tile_bf16(qs, k + b * k_sb + h * k_sh, k_sn, n0, kv_eff);
    load_tile_bf16(dos, v + b * v_sb + h * v_sh, v_sn, n0, kv_eff);
    __syncthreads();
    uint32_t kf[4][4], vf[4][4];
    load_a_frags(kf, qs, warp, lane);
    load_a_frags(vf, dos, warp, lane);
    // this thread's key rows: r = 0 -> lane/4, r = 1 -> lane/4 + 8
    const int key0 = n0 + warp * 16 + lane / 4;
    const bool live[2] = {key0 < kv_eff, key0 + 8 < kv_eff};

    for (int m0 = 0; m0 < nq; m0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile_bf16(qs, qb, q_sn, m0, nq);
      load_tile_bf16(dos, dob, do_sn, m0, nq);
      if (threadIdx.x < kTile) {
        const int row = m0 + threadIdx.x;
        lse_s[threadIdx.x] = row < nq ? lse_bh[row] : INFINITY;
        delta_s[threadIdx.x] = row < nq ? delta_bh[row] : 0.f;
      }
      __syncthreads();

      float pt[8][4];  // S^T = K Q^T, then P^T: keys x 64 q columns
      mma_a_times_tile_t(pt, kf, qs, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = j * 8 + (lane % 4) * 2 + (c & 1);
          pt[j][c] = live[c / 2] ? exp2f(pt[j][c] * qscale - lse_s[col]) : 0.f;
        }

      float dst[8][4];  // dP^T = V dO^T, then dS^T
      mma_a_times_tile_t(dst, vf, dos, lane);

      mma_acc_times_tile(dv_acc, pt, dos, lane);  // dV += P^T dO

#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = j * 8 + (lane % 4) * 2 + (c & 1);
          dst[j][c] = pt[j][c] * (dst[j][c] - delta_s[col]);
        }

      mma_acc_times_tile(dk_acc, dst, qs, lane);  // dK += dS^T Q
    }
  }

  __nv_bfloat16* dkb = dk + b * dk_sb + h * dk_sh;
  __nv_bfloat16* dvb = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + warp * 16 + lane / 4 + r * 8;
    if (row < nk) {
      store_row_bf16(dkb, dk_sn, row, dk_acc, r, scale, lane);
      store_row_bf16(dvb, dv_sn, row, dv_acc, r, 1.f, lane);
    }
  }
}

// One block per (64-row q tile, batch * head). Each warp owns 16 q rows;
// the loop streams 64-key tiles of K and V.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        int64_t q_sb, int64_t q_sn, int64_t q_sh,
                        int64_t k_sb, int64_t k_sn, int64_t k_sh,
                        int64_t v_sb, int64_t v_sn, int64_t v_sh,
                        int64_t do_sb, int64_t do_sn, int64_t do_sh,
                        int64_t dq_sb, int64_t dq_sn, int64_t dq_sh,
                        int heads, int nq, int kv_eff, float qscale,
                        float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kHPitch];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // Q and dO rows of this block as A fragments (the K/V buffers are free
  // until the loop starts)
  load_tile_bf16(ks, q + b * q_sb + h * q_sh, q_sn, m0, nq);
  load_tile_bf16(vs, dout + b * do_sb + h * do_sh, do_sn, m0, nq);
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, ks, warp, lane);
  load_a_frags(dof, vs, warp, lane);

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + lane / 4 + r * 8;
    const int64_t idx = static_cast<int64_t>(blockIdx.y) * nq + row;
    lse_r[r] = row < nq ? lse[idx] : INFINITY;
    delta_r[r] = row < nq ? delta[idx] : 0.f;
  }

  float dq_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[j][c] = 0.f;

  for (int n0 = 0; n0 < kv_eff; n0 += kTile) {
    __syncthreads();  // the previous tile's readers (or the fragments) are done
    load_tile_bf16(ks, kb, k_sn, n0, kv_eff);
    load_tile_bf16(vs, vb, v_sn, n0, kv_eff);
    __syncthreads();

    float p[8][4];  // S = Q K^T, then P
    mma_a_times_tile_t(p, qf, ks, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = n0 + j * 8 + (lane % 4) * 2 + (c & 1);
        p[j][c] = key < kv_eff ? exp2f(p[j][c] * qscale - lse_r[c / 2]) : 0.f;
      }

    float ds[8][4];  // dP = dO V^T, then dS
    mma_a_times_tile_t(ds, dof, vs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[j][c] = p[j][c] * (ds[j][c] - delta_r[c / 2]);

    mma_acc_times_tile(dq_acc, ds, ks, lane);  // dQ += dS K
  }

  __nv_bfloat16* dqb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + lane / 4 + r * 8;
    if (row < nq) store_row_bf16(dqb, dq_sn, row, dq_acc, r, scale, lane);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.
//   q, k, v, dout and the outputs: bfloat16, unit stride along D = 64
//   lse, delta: (batch, heads, nq) float32, contiguous
//   strides: element strides (batch, token, head) of q, k, v, dout, then
//            the outputs (dk, dv for dkv; dq for dq)
//   qscale: softmax scale times log2(e); scale: the softmax scale
// Each returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int64_t batch, int64_t heads, int64_t nq,
                                  int64_t nk, int64_t kv_eff,
                                  const int64_t* st, float qscale, float scale,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned>((nk + kTile - 1) / kTile),
                  static_cast<unsigned>(batch * heads));
  flash_bwd_dkv_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      static_cast<int>(heads), static_cast<int>(nq), static_cast<int>(nk),
      static_cast<int>(kv_eff), qscale, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int64_t batch,
                                 int64_t heads, int64_t nq, int64_t kv_eff,
                                 const int64_t* st, float qscale, float scale,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned>((nq + kTile - 1) / kTile),
                  static_cast<unsigned>(batch * heads));
  flash_bwd_dq_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], static_cast<int>(heads), static_cast<int>(nq),
      static_cast<int>(kv_eff), qscale, scale);
  return static_cast<int>(cudaGetLastError());
}
