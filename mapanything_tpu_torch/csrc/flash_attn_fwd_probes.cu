// The Hopper counterparts of the JAX package's TPU tuning probes (ROADMAP
// queue B, B9: scripts/perf/flash_bottleneck_probe.py::_kernel,
// flash_longseq_tuning.py::_kernel_bf16p, flash_multihead_experiment.py::
// _kernel_g, qkv_layout_experiment.py::flash_bh, attn_alignment_experiment.py
// ::_kernel_nhd, flash_sumfuse_experiment.py::_kernel_1pass_sumfuse): each is
// an instantiation of the main forward's template (csrc/flash_fwd_sm90.cuh),
// kOut epilogue, built into this library apart from the main path's.
// mapanything_tpu_torch/perf/flash_probes.py names them, holds each against
// its plain version and times them. Heads per block, the persistent grid
// and the input layouts are arguments of the main configuration; the rest
// are template variants, one per index below. The mma.sync baseline
// (csrc/flash_attn_fwd_mma.cu) is linked into the same library.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_sm90;

template <int kWG, int kBN, int kStages, int kSoftmax = kOnline,
          bool kExpBf16 = false, bool kSumFuse = false, bool kPingPong = false,
          bool kWarpSpec = true>
using P = Config<kOut, kWG, kBN, kStages, kSoftmax, kExpBf16, kSumFuse,
                 kPingPong, kWarpSpec>;

// the variants, in the order of perf/flash_probes.py::VARIANTS
using V0 = P<3, 128, 3>;  // main: 192 x 128 rows x keys, 3 stages
// step (a): one warpgroup, no producer
using V1 = P<1, 128, 2, kOnline, false, false, false, false>;
using V2 = P<3, 128, 3, kNoMax>;  // exp2, no running max
using V3 = P<3, 128, 3, kNoExp>;  // P = S': the products alone
using V4 = P<3, 128, 3, kOnline, true>;  // exp2 on packed bf16
using V5 = P<3, 128, 3, kOnline, false, true>;  // row sum by the P V product
using V6 = P<2, 128, 2, kOnline, false, false, true>;  // 128 x 128, ping-pong
using V7 = P<1, 128, 2>;  // 64 x 128
using V8 = P<1, 176, 2>;  // 64 x 176
using V9 = P<2, 64, 2>;  // 128 x 64
using V10 = P<2, 176, 2>;  // 128 x 176
using V11 = P<2, 128, 3>;  // 128 x 128, 3 stages
using V12 = P<2, 176, 3>;  // 128 x 176, 3 stages
using V13 = P<3, 64, 2>;  // 192 x 64
using V14 = P<2, 128, 2>;  // 128 x 128
using V15 = P<3, 128, 2>;  // 192 x 128, 2 stages

}  // namespace

// As flash_attn_fwd (csrc/flash_attn_fwd_sm90.cu), with the variant's index,
// the heads per block and a persistent grid's block count (0: none).
// Returns 10003 for an unknown variant.
extern "C" int flash_attn_fwd_probe(int variant, const void* q, const void* k,
                                    const void* v, void* o, int64_t batch,
                                    int64_t heads, int64_t nq, int64_t kv_eff,
                                    const int64_t* st, float qscale,
                                    int heads_per_block,
                                    int persistent_blocks, void* stream) {
  switch (variant) {
    case 0:
      return launch<V0>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 1:
      return launch<V1>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 2:
      return launch<V2>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 3:
      return launch<V3>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 4:
      return launch<V4>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 5:
      return launch<V5>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 6:
      return launch<V6>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 7:
      return launch<V7>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 8:
      return launch<V8>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 9:
      return launch<V9>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 10:
      return launch<V10>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 11:
      return launch<V11>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 12:
      return launch<V12>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 13:
      return launch<V13>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 14:
      return launch<V14>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    case 15:
      return launch<V15>(q, k, v, o, nullptr, nullptr, batch, heads, nq,
                         kv_eff, st, qscale, heads_per_block,
                         persistent_blocks, stream);
    default:
      return 10003;
  }
}

// The dynamic shared memory a launch of variant `variant` asks for (-1: no
// such variant).
extern "C" int flash_attn_fwd_probe_smem_bytes(int variant) {
  constexpr int bytes[] = {
      V0::kSmem, V1::kSmem, V2::kSmem, V3::kSmem, V4::kSmem, V5::kSmem,
      V6::kSmem, V7::kSmem, V8::kSmem, V9::kSmem, V10::kSmem, V11::kSmem,
      V12::kSmem, V13::kSmem, V14::kSmem, V15::kSmem};
  constexpr int count = static_cast<int>(sizeof(bytes) / sizeof(int));
  return variant >= 0 && variant < count ? bytes[variant] : -1;
}
