// The main path's P^T dO on Hopper: the TMA/wgmma kernel of
// csrc/flash_pt_do_sm90.cuh (design and bound are described there).
//
// Replaces the Pallas kernel of the JAX package
//   mapanything_tpu/ops/ring_attention.py::_pt_do_kernel
//   (flash_attn_bwd_pt_do)
// The mma.sync kernel it replaced stays as the baseline,
// csrc/flash_attn_pt_do_mma.cu, in the probe library.
//
// Layout: q, dO (B, Nq, H, 64) and k (B, Nk, H, 64) bf16, read by TMA
// through their (batch, token, head) strides (unit stride along D, strides
// and base 16-byte aligned); out (B, Nk, H, 64) fp32; lse contiguous
// (B, H, Nq) fp32 (+inf for a row that saw no key: it adds nothing).

#include "flash_pt_do_sm90.cuh"

// Plain C entry point, bound with ctypes. strides: element strides (batch,
// token, head) of q, k, dout and out; qscale: the softmax scale times
// log2(e). Returns 0, a cudaError_t, or the tensor-map error codes of
// csrc/sm90_common.cuh (10001, 10002).
extern "C" int flash_attn_bwd_pt_do(const void* q, const void* k,
                                    const void* dout, const void* lse,
                                    void* out, int64_t batch, int64_t heads,
                                    int64_t nq, int64_t nk, const int64_t* st,
                                    float qscale, void* stream) {
  return flash_sm90::launch_pt_do(q, k, dout, lse, out, batch, heads, nq, nk,
                                  st, qscale, stream);
}
