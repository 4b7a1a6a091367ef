// The main path's flash-attention forward on Hopper: the TMA/wgmma kernel of
// csrc/flash_fwd_sm90.cuh (design, bound and variants are described there)
// in its main configuration, with three epilogues.
//
// Replaces the five forward Pallas kernels of the JAX package:
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_1pass_T (kv <= 2816)
//   mapanything_tpu/ops/flash_attention.py::_flash_kernel_T       (online)
//   (flash_attn_fwd: the bf16 output)
//   mapanything_tpu/ops/flash_attention_bwd.py::_fwd_with_lse_kernel_1pass_T
//   mapanything_tpu/ops/flash_attention_bwd.py::_fwd_with_lse_kernel_T
//   (flash_attn_fwd_lse: the output and the base-2 lse the backward reads)
//   mapanything_tpu/ops/ring_attention.py::_flash_stats_kernel
//   (flash_attn_fwd_stats: the ring's unnormalised fp32 accumulator, m, l)
//
// Layout: q (B, Nq, H, 64), k and v (B, Nk, H, 64), bf16, read by TMA
// through their (batch, token, head) strides (unit stride along D, strides
// and base 16-byte aligned); v may be k. o is written the same way (bf16,
// or fp32 for the stats), lse as a contiguous (B, H, Nq) fp32 tensor, the
// stats' m and l as contiguous (B, Nq, H) fp32 tensors. Keys at index >=
// kv_eff are excluded: TMA reads them as zeros and their scores are -inf.
// The lse is base 2 in the scaled-logit domain (m + log2 l); a row that
// sees no key writes 0, lse +inf, or (stats) m = -inf and l = 0.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_sm90;

// 192 query rows (three consumer warpgroups) by 128-key tiles, three
// stages: the fastest configuration of the probe sweep
// (perf/flash_probes.py) at every main-path shape (PERF.md)
template <int kMode>
using Main = Config<kMode, 3, 128, 3>;

}  // namespace

// Plain C entry points, bound with ctypes.
//   q, k, v: bfloat16; o: bfloat16 (flash_attn_fwd, flash_attn_fwd_lse) or
//     the fp32 unnormalised accumulator (flash_attn_fwd_stats)
//   lse: (batch, heads, nq) float32, contiguous (flash_attn_fwd_lse only)
//   m, l: (batch, nq, heads) float32, contiguous (flash_attn_fwd_stats only)
//   strides: 12 element strides, (batch, token, head) for q, k, v, o
//   qscale: softmax scale times log2(e)
// Each returns 0, a cudaError_t, or flash_sm90's tensor-map error codes
// (10001: the CUDA driver lacks cuTensorMapEncodeTiled, 10002: it refused
// a map).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int64_t batch, int64_t heads,
                              int64_t nq, int64_t kv_eff, const int64_t* st,
                              float qscale, void* stream) {
  return launch<Main<kOut>>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                            kv_eff, st, qscale, 1, 0, stream);
}

extern "C" int flash_attn_fwd_lse(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int64_t batch,
                                  int64_t heads, int64_t nq, int64_t kv_eff,
                                  const int64_t* st, float qscale,
                                  void* stream) {
  return launch<Main<kOutLse>>(q, k, v, o, static_cast<float*>(lse), nullptr,
                               batch, heads, nq, kv_eff, st, qscale, 1, 0,
                               stream);
}

extern "C" int flash_attn_fwd_stats(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int64_t batch, int64_t heads,
                                    int64_t nq, int64_t kv_eff,
                                    const int64_t* st, float qscale,
                                    void* stream) {
  return launch<Main<kStats>>(q, k, v, acc, static_cast<float*>(m),
                              static_cast<float*>(l), batch, heads, nq, kv_eff,
                              st, qscale, 1, 0, stream);
}

// The dynamic shared memory each launch of these entries asks for.
extern "C" int flash_attn_fwd_smem_bytes() { return Main<kOut>::kSmem; }
