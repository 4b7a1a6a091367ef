// P^T dO for the ring's lse-cotangent backward (sm_90a, mma.sync): the dV
// arm of the dK/dV pass alone, out_j = sum_i exp2(s'_ij - lse_i) dO_i in
// fp32, without the dP, dS and dK products.
//
// The baseline of the main path's TMA/wgmma P^T dO
// (csrc/flash_attn_pt_do_sm90.cu), which replaced it there: the kernel that
// replaced the Pallas kernel of the JAX package
//   mapanything_tpu/ops/ring_attention.py::_pt_do_kernel
// first, on the design of the mma.sync backward (csrc/flash_attn_bwd_mma.cu)
// and its building blocks from csrc/flash_attn_common.cuh. Built into the
// probe library (entry flash_attn_bwd_pt_do_mma); nothing on the main path
// launches it.
//
// Layout: q, dO (B, Nq, H, 64) and k (B, Nk, H, 64) bf16, unit stride along
// D; out (B, Nk, H, 64) fp32; lse contiguous (B, H, Nq) fp32 (+inf for a row
// that saw no key, and q rows past nq get zero weight the same way).

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// out = P^T dO, fp32: the dV arm of the dK/dV pass alone. One block
// per (64-key tile, batch * head); each warp owns 16 key rows, the loop
// streams 64-row tiles of Q and dO. Two 64-deep products per tile pair
// (S^T, then P^T dO), so it is compute bound like the others. Every key row
// below nk is real (a ring shard has no padding); the ragged last tile's
// rows past nk are zeros and are not written.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_pt_do_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ out,
                           int64_t q_sb, int64_t q_sn, int64_t q_sh,
                           int64_t k_sb, int64_t k_sn, int64_t k_sh,
                           int64_t do_sb, int64_t do_sn, int64_t do_sh,
                           int64_t o_sb, int64_t o_sn, int64_t o_sh,
                           int heads, int nq, int nk, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kHPitch];
  __shared__ float lse_s[kTile];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lse_bh = lse + static_cast<int64_t>(blockIdx.y) * nq;

  // this block's K rows as A fragments (rows past nk are zeros)
  load_tile_bf16(qs, k + b * k_sb + h * k_sh, k_sn, n0, nk);
  __syncthreads();
  uint32_t kf[4][4];
  load_a_frags(kf, qs, warp, lane);
  const int key0 = n0 + warp * 16 + lane / 4;
  const bool live[2] = {key0 < nk, key0 + 8 < nk};

  float acc[8][4];  // this warp's 16 keys x 64 dims
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int m0 = 0; m0 < nq; m0 += kTile) {
    __syncthreads();  // the previous tile's readers (or the fragments) are done
    load_tile_bf16(qs, qb, q_sn, m0, nq);
    load_tile_bf16(dos, dob, do_sn, m0, nq);
    if (threadIdx.x < kTile) {
      const int row = m0 + threadIdx.x;
      lse_s[threadIdx.x] = row < nq ? lse_bh[row] : INFINITY;
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
    mma_acc_times_tile(acc, pt, dos, lane);  // out += P^T dO
  }

  float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + warp * 16 + lane / 4 + r * 8;
    if (row < nk) store_row(ob, o_sn, row, acc, r, 1.f, lane);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. strides: element strides (batch,
// token, head) of q, k, dout and out; qscale: the softmax scale times
// log2(e). Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_bwd_pt_do_mma(const void* q, const void* k,
                                        const void* dout, const void* lse,
                                        void* out, int64_t batch,
                                        int64_t heads, int64_t nq, int64_t nk,
                                        const int64_t* st, float qscale,
                                        void* stream) {
  const dim3 grid(static_cast<unsigned>((nk + kTile - 1) / kTile),
                  static_cast<unsigned>(batch * heads));
  flash_bwd_pt_do_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(out), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      static_cast<int>(heads), static_cast<int>(nq), static_cast<int>(nk),
      qscale);
  return static_cast<int>(cudaGetLastError());
}
