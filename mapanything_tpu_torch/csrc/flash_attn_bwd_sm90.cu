// The main path's flash-attention backward on Hopper: the TMA/wgmma kernels
// of csrc/flash_bwd_sm90.cuh (design and bound are described there), each
// writing bf16 or fp32.
//
// Replaces the two backward Pallas kernels of the JAX package:
//   mapanything_tpu/ops/flash_attention_bwd.py::_dkv_kernel
//   (flash_attn_bwd_dkv, flash_attn_bwd_dkv_f32)
//   mapanything_tpu/ops/flash_attention_bwd.py::_dq_kernel
//   (flash_attn_bwd_dq, flash_attn_bwd_dq_f32)
// The fp32 forms are the ring backward's per-pair partials
// (ops/ring_attention.py::_pair_bwd). The mma.sync kernels they replaced
// stay as the baseline, csrc/flash_attn_bwd_mma.cu, in the probe library.
//
// Layout: q, dO, dQ (B, Nq, H, 64); k, v, dK, dV (B, Nk, H, 64); inputs
// bf16 and read by TMA through their (batch, token, head) strides (unit
// stride along D, strides and base 16-byte aligned); lse and delta
// contiguous (B, H, Nq) fp32. Keys at or past kv_eff get zero gradient rows.

#include "flash_bwd_sm90.cuh"

using flash_sm90::kBwdSmem;
using flash_sm90::launch_dkv;
using flash_sm90::launch_dq;

// Plain C entry points, bound with ctypes.
//   q, k, v, dout: bfloat16; the outputs bfloat16 (flash_attn_bwd_dkv, _dq)
//     or float32 (the _f32 forms)
//   lse, delta: (batch, heads, nq) float32, contiguous
//   strides: element strides (batch, token, head) of q, k, v, dout, then
//     the outputs (dk, dv for dkv; dq for dq)
//   qscale: softmax scale times log2(e); scale: the softmax scale
// Each returns 0, a cudaError_t, or the tensor-map error codes of
// csrc/sm90_common.cuh (10001: the CUDA driver lacks
// cuTensorMapEncodeTiled, 10002: it refused a map).
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int64_t batch, int64_t heads, int64_t nq,
                                  int64_t nk, int64_t kv_eff,
                                  const int64_t* st, float qscale, float scale,
                                  void* stream) {
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, batch,
                                   heads, nq, nk, kv_eff, st, qscale, scale,
                                   stream);
}

extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int64_t batch,
                                      int64_t heads, int64_t nq, int64_t nk,
                                      int64_t kv_eff, const int64_t* st,
                                      float qscale, float scale,
                                      void* stream) {
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                           nq, nk, kv_eff, st, qscale, scale, stream);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int64_t batch,
                                 int64_t heads, int64_t nq, int64_t kv_eff,
                                 const int64_t* st, float qscale, float scale,
                                 void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, batch, heads,
                                  nq, kv_eff, st, qscale, scale, stream);
}

extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int64_t batch, int64_t heads,
                                     int64_t nq, int64_t kv_eff,
                                     const int64_t* st, float qscale,
                                     float scale, void* stream) {
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, batch, heads, nq,
                          kv_eff, st, qscale, scale, stream);
}

// The dynamic shared memory each launch of these entries asks for.
extern "C" int flash_attn_bwd_smem_bytes() { return kBwdSmem; }
