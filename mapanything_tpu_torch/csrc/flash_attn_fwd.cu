// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * d^-1/2) V.
//
// Replaces the two serving-path Pallas kernels of the JAX package:
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_1pass_T (kv <= 2816)
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_T       (online, kv > 2816)
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
// for the tensor cores, as the JAX package does. Inputs are bf16 only (the
// serving path's dtype); the wrapper rejects anything else.
//
// wgmma, TMA, cp.async pipelining and warp specialisation are the work of
// the PRs that make this kernel fast.
//
// Layout: q (B, Nq, H, 64), k and v (B, Nk, H, 64), read through their
// (batch, token, head) strides with unit stride along D; o is written the
// same way. Keys at index >= kv_eff are excluded (the aligned-token n_valid
// mask): they are loaded as zeros and their scores set to -inf. A row that
// sees no key is written as 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // q rows per block (head dim 64 throughout)
constexpr int kBN = 64;  // keys per tile

constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows
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

// rows [row0, row0 + 64) of a (tokens, 64) bf16 matrix -> dst[row][d] in
// shared memory; rows at or past `limit` are zeros. Eight consecutive
// threads copy one row (128 contiguous bytes).
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int64_t row_stride, int row0,
                                               int limit) {
  for (int i = threadIdx.x; i < kBM * 8; i += kMmaThreads) {
    const int r = i / 8;
    const int c = (i % 8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kHPitch + c) = val;
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         int64_t q_sb, int64_t q_sn, int64_t q_sh,
                         int64_t k_sb, int64_t k_sn, int64_t k_sh,
                         int64_t v_sb, int64_t v_sn, int64_t v_sh,
                         int64_t o_sb, int64_t o_sn, int64_t o_sh,
                         int heads, int nq, int kv_eff, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBM * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * kHPitch];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kHPitch];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kBM;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this thread's rows in the warp's 16-row slice: lane/4 and lane/4 + 8;
  // its columns in each 8-wide n-tile: (lane%4)*2 and (lane%4)*2 + 1

  load_tile_bf16(qs, qb, q_sn, m0, nq);
  __syncthreads();
  uint32_t qf[4][4];  // A fragments of Q, one per 16-wide slice of D
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk],
                &qs[(warp * 16 + lane % 16) * kHPitch + kk * 16 + (lane / 16) * 8]);

  float acc[8][4];  // O: 8 n-tiles of 8 dims
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int n0 = 0; n0 < kv_eff; n0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16(ks, kb, k_sn, n0, kv_eff);
    load_tile_bf16(vs, vb, v_sn, n0, kv_eff);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bf[4];  // b-fragments of n-tiles j and j+1
        ldmatrix_x4(bf, &ks[(j * 8 + (lane / 16) * 8 + lane % 8) * kHPitch +
                            kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[j], qf[kk], bf[0], bf[1]);
        mma_bf16(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

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

    // O += P V: the S accumulators of n-tiles 2t, 2t+1 are the A fragment
    // of the 16-key slice t
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pa[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pa[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pa[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bf[4];  // b-fragments of dim tiles j and j+1
        ldmatrix_x4_trans(bf, &vs[(t * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      kHPitch + j * 8 + (lane / 16) * 8]);
        mma_bf16(acc[j], pa, bf[0], bf[1]);
        mma_bf16(acc[j + 1], pa, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float li = l[r];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = (li == 0.f) ? 0.f : 1.f / li;
    const int row = m0 + warp * 16 + lane / 4 + r * 8;
    if (row < nq) {
      __nv_bfloat16* dst = ob + static_cast<int64_t>(row) * o_sn + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   q, k, v, o: bfloat16
//   strides: 12 element strides, (batch, token, head) for q, k, v, o
//   qscale: softmax scale times log2(e)
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int64_t batch, int64_t heads,
                              int64_t nq, int64_t kv_eff, const int64_t* st,
                              float qscale, void* stream) {
  const dim3 grid(static_cast<unsigned>((nq + kBM - 1) / kBM),
                  static_cast<unsigned>(batch * heads));
  flash_fwd_mma_kernel<<<grid, kMmaThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], static_cast<int>(heads), static_cast<int>(nq),
      static_cast<int>(kv_eff), qscale);
  return static_cast<int>(cudaGetLastError());
}
