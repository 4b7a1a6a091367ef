"""The port's ring attention (ops/ring_attention.py, nn/layers.py's
RingGlobalBlock) against the JAX package's, on the CPU.

Single-process tests hold the plain twins of the ring's kernels against the
JAX Pallas functions run in interpret mode (their own `interpret`
argument): the stats forward on a ragged kv of 300 with 128-blocks, P^T dO,
and the per-pair backward with fp32 outputs. The ring itself runs over gloo
on 2 and 4 spawned CPU ranks (parallel/distributed.py::spawn_cpu_ranks);
each rank writes its results and this process gathers them and holds them
against JAX on a CPU mesh of the same ring size: the forward against
`ring_sdpa`, the lse-free ring's gradients against
`ring_flash_attention_trainable`'s, the with-lse ring's gradients for both
outputs against `ring_flash_attention_with_lse`'s, RingGlobalBlock with the
scale token against the JAX Block's gradient on [x; tok], and with entropy
scaling against the JAX Block's forward on [x; tok]. JAX is imported inside
the tests and fixtures only, so the spawned ranks load torch alone.

Everything is fp32; the JAX side runs under
jax.default_matmul_precision("highest"). Tolerances: 2e-5 abs / 2e-4 rel for
forwards (the JAX ring test's), 2e-4 abs / 1e-3 rel for gradients (the JAX
package's own for its backward kernels).
"""

import os

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.nn import layers as PL
from mapanything_tpu_torch.ops import ring_attention as R
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention_plain,
    reset_launch_counts,
)
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention as fa_fn,
)
from mapanything_tpu_torch.parallel import spawn_cpu_ranks

FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed, n, b=1, h=2, d=64):
    return [_rand(seed + i, b, n, h, d) for i in range(3)]


def _highest():
    import jax

    return jax.default_matmul_precision("highest")


# --- the kernels' plain twins against the Pallas functions -----------------


def test_stats_plain_matches_jax_pallas():
    from mapanything_tpu.ops.ring_attention import flash_attention_stats

    q, k, v = _qkv(0, 300)  # ragged against the 128 blocks
    with _highest():
        ref = flash_attention_stats(q, k, v, block_q=128, block_k=128,
                                    interpret=True)
    reset_launch_counts()
    out = R.flash_attention_stats(*map(torch.from_numpy, (q, k, v)))
    assert fa_fn.plain_launches == 1 and fa_fn.kernel_launches == 0
    for name, a, r in zip(("acc", "m", "l"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **FWD_TOL)


@pytest.mark.parametrize("split", [128, 300])
def test_split_and_merge_equals_full_attention(split):
    """Stats over a kv split merge to full attention; split=300 leaves an
    empty second shard, whose m = -inf and l = 0 the merge must ignore."""
    q, k, v = map(torch.from_numpy, _qkv(1, 300))
    parts = [R.flash_attention_stats(q, k[:, a:b], v[:, a:b])
             for a, b in ((0, split), (split, 300))]
    acc, m, l = R.merge_stats(*parts[0], *parts[1])
    torch.testing.assert_close(acc / l[..., None],
                               flash_attention_plain(q, k, v), **FWD_TOL)
    if split == 300:
        assert torch.isinf(parts[1][1]).all() and not parts[1][2].any()


def test_merge_of_two_empty_states_stays_empty():
    no_keys = torch.zeros(1, 0, 2, 64)
    empty = R.flash_attention_stats(torch.from_numpy(_rand(2, 1, 8, 2, 64)),
                                    no_keys, no_keys)
    acc, m, l = R.merge_stats(*empty, *empty)
    assert torch.isneginf(m).all() and not l.any() and not acc.any()
    assert not acc.isnan().any()


def _jax_lse2_delta(q, k, v, g):
    """JAX's full-sequence base-2 lse and delta of one shard, (B, N, H)."""
    import jax.numpy as jnp

    from mapanything_tpu.ops.ring_attention import flash_attention_stats

    acc, m, l = flash_attention_stats(q, k, v, block_q=128, block_k=128,
                                      interpret=True)
    out = acc / l[..., None]
    return m + jnp.log2(l), jnp.sum(g * out, axis=-1)


def test_pt_do_plain_matches_jax_pallas():
    from mapanything_tpu.ops.ring_attention import _pair_pt_do

    q, k, v = _qkv(3, 256)
    g = _rand(6, *q.shape)
    with _highest():
        lse2, _ = _jax_lse2_delta(q, k, v, g)
        ref = _pair_pt_do(q, k[:, :128], g, lse2, interpret=True)
    lse_t = torch.from_numpy(np.array(lse2)).transpose(1, 2).contiguous()
    out = R.flash_attention_pt_do(torch.from_numpy(q),
                                  torch.from_numpy(k[:, :128]),
                                  torch.from_numpy(g), lse_t)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


def test_pair_bwd_fp32_matches_jax_pallas():
    """One pair of the ring backward (half the keys) with the global lse:
    dq, dk, dv in fp32, as JAX's `_pair_bwd`."""
    from mapanything_tpu.ops.ring_attention import _pair_bwd

    q, k, v = _qkv(7, 256)
    g = _rand(10, *q.shape)
    with _highest():
        lse2, delta = _jax_lse2_delta(q, k, v, g)
        ref = _pair_bwd(q, k[:, 128:], v[:, 128:], g, lse2, delta,
                        interpret=True)
    t = torch.from_numpy
    out = R._pair_bwd(t(q), t(k[:, 128:]), t(v[:, 128:]), t(g),
                      t(np.array(lse2)).transpose(1, 2).contiguous(),
                      t(np.array(delta)).transpose(1, 2).contiguous())
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_entropy_scaling_is_not_ported():
    """Entropy scaling on the ring at p = 1 (the name is the test's from
    before the scaling was ported): the ring block with base 16
    over 48 patches and the token equals the plain Block with the same
    base on [patches; token] (the scaling counts every rank's patches and
    the token; tests/test_torch_variants.py holds Block against JAX)."""
    from mapanything_tpu_torch.parallel import init_distributed

    torch.manual_seed(0)
    blk = PL.init_weights_(PL.Block(64, 2), torch.Generator().manual_seed(1))
    x, tok = torch.randn(1, 48, 64), torch.randn(1, 1, 64)
    group = init_distributed(device="cpu")
    try:
        with torch.no_grad():
            got_x, got_t = PL.RingGlobalBlock(blk, entropy_scaling_base=16)(
                x, tok, group)
            ref = blk(torch.cat([x, tok], dim=1), entropy_scaling_base=16)
            plain = blk(torch.cat([x, tok], dim=1))
    finally:
        torch.distributed.destroy_process_group()
    torch.testing.assert_close(torch.cat([got_x, got_t], dim=1), ref,
                               **FWD_TOL)
    assert (ref - plain).abs().max() > 1e-5  # the scaling took effect


# --- the ring over gloo ----------------------------------------------------

N, DIM, HEADS = 256, 64, 2  # tokens of the ring tests; the block's width
# below N + 1, so that the scaling takes effect; counting one rank's
# patches instead of every rank's would give another factor
ENTROPY_BASE = 16


def _ring_rank(group, folder):
    """One rank: ring forward, the with-lse ring's gradients, and the ring
    block with the token; writes this rank's results to `folder`."""
    import torch.distributed as dist

    rank, p = dist.get_rank(group), dist.get_world_size(group)
    inp = np.load(os.path.join(folder, "inputs.npz"))
    rows = slice(rank * N // p, (rank + 1) * N // p)
    res = {}

    q, k, v = (torch.from_numpy(inp[n][:, rows]) for n in ("q", "k", "v"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = R.ring_flash_attention(*leaves, group)
    (out**2).sum().backward()
    res["out"] = out.detach().numpy()
    for name, x in zip(("ring_dq", "ring_dk", "ring_dv"), leaves):
        res[name] = x.grad.numpy()

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = R.ring_flash_attention_with_lse(*leaves, group)
    ((out**2).sum() + torch.sin(lse).sum()).backward()
    for name, x in zip(("dq", "dk", "dv"), leaves):
        res[name] = x.grad.numpy()

    blk = PL.Block(DIM, HEADS)
    blk.load_state_dict({key[6:]: torch.from_numpy(inp[key])
                         for key in inp.files if key.startswith("block.")})
    x = torch.from_numpy(inp["x"][:, rows]).requires_grad_()
    tok = torch.from_numpy(inp["tok"]).requires_grad_()
    with torch.no_grad():  # no extra token: the lse-free ring
        res["out_no_token"] = PL.RingGlobalBlock(blk)(
            x, tok[:, :0], group)[0].numpy()
        res["entropy_x"], res["entropy_tok"] = (
            out.numpy() for out in PL.RingGlobalBlock(
                blk, entropy_scaling_base=ENTROPY_BASE)(x, tok, group))
    out_x, out_t = PL.RingGlobalBlock(blk)(x, tok, group)
    # the token output is replicated: count it once over the ranks
    ((out_x**2).sum() + (out_t**2).sum() / p).backward()
    res["dx"] = x.grad.numpy()
    grads = [tok.grad] + [prm.grad for _, prm in blk.named_parameters()]
    for g in grads:
        dist.all_reduce(g, group=group)
    res["dtok"] = tok.grad.numpy()
    for name, prm in blk.named_parameters():
        res[f"grad.{name}"] = prm.grad.numpy()
    np.savez(os.path.join(folder, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def ring_run(request, tmp_path_factory):
    """Inputs, the JAX Block's params, and every rank's results."""
    import jax

    from mapanything_tpu.nn.layers import Block as JaxBlock
    from mapanything_tpu_torch.utils.weights import from_jax_params

    p = request.param
    folder = str(tmp_path_factory.mktemp(f"ring{p}"))
    q, k, v = _qkv(20, N)
    x = _rand(23, 1, N, DIM)
    tok = _rand(24, 1, 1, DIM)
    jblk = JaxBlock(DIM, HEADS, attn_impl="xla")
    with _highest():
        params = jblk.init(jax.random.PRNGKey(0),
                           np.concatenate([x, tok], axis=1))
    rng = np.random.default_rng(25)  # move LayerNorm off its constants
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    state = from_jax_params(params, PL.Block(DIM, HEADS))
    np.savez(os.path.join(folder, "inputs.npz"), q=q, k=k, v=v, x=x,
             tok=tok, **{f"block.{key}": np.ascontiguousarray(val)
                         for key, val in state.items()})
    spawn_cpu_ranks(_ring_rank, p, folder)
    ranks = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
             for r in range(p)]
    return dict(p=p, folder=folder, q=q, k=k, v=v, x=x, tok=tok,
                params=params, ranks=ranks)


def _cat(run, key):
    return np.concatenate([r[key] for r in run["ranks"]], axis=1)


def _mesh(p):
    import jax

    from mapanything_tpu.parallel import make_mesh

    return make_mesh(n_data=1, n_model=p, devices=jax.devices()[:p])


def _shard_map(fn, p, in_specs, out_specs):
    from jax import shard_map

    return shard_map(fn, mesh=_mesh(p), in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def test_ring_forward_matches_jax_ring(ring_run):
    from mapanything_tpu.ops.ring_attention import ring_sdpa

    run = ring_run
    with _highest():
        ref = ring_sdpa(run["q"], run["k"], run["v"], _mesh(run["p"]),
                        interpret=True)
    np.testing.assert_allclose(_cat(run, "out"), np.asarray(ref), **FWD_TOL)


def _dense_attention(q, k, v):
    """out and the base-2 lse (B, N, H) of full attention in jnp: the JAX
    ring test's reference (tests/test_ring_attention.py::TestRingWithLse)."""
    import jax.numpy as jnp

    s = jnp.einsum("bnhd,bmhd->bhnm", q, k) * (64**-0.5 * 1.4426950408889634)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp2(s - m)
    l = jnp.sum(p, axis=-1)
    out = jnp.einsum("bhnm,bmhd->bnhd", p / l[..., None], v)
    return out, jnp.swapaxes(m[..., 0] + jnp.log2(l), 1, 2)


def _ring_grads_vs_jax(run, prefix, loss, ring_fn):
    """dq, dk, dv of `loss(out, lse)` on every rank, concatenated, against
    JAX: at p = 2 the JAX ring `ring_fn` under shard_map, the loss psum'd
    over ranks; at p = 4 jax.grad of the dense jnp attention (the
    interpret-mode ring backward takes ~12 s per ring size on the CPU)."""
    import jax
    from jax.sharding import PartitionSpec as P

    def local(qs, ks, vs):
        return jax.lax.psum(loss(*ring_fn(qs, ks, vs)), "model")

    def dense(q, k, v):
        return loss(*_dense_attention(q, k, v))

    spec = P(None, "model", None, None)
    fn = (_shard_map(local, run["p"], (spec,) * 3, P()) if run["p"] == 2
          else dense)
    with _highest():
        ref = jax.grad(fn, argnums=(0, 1, 2))(run["q"], run["k"], run["v"])
    for name, r in zip(("dq", "dk", "dv"), ref):
        got = _cat(run, prefix + name)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_ring_grads_match_jax_ring(ring_run):
    """The lse-free ring's backward (RingFlashAttention, the token-free
    block's) against JAX's ring_flash_attention_trainable with the same
    loss, sum(out^2)."""
    import jax.numpy as jnp

    from mapanything_tpu.ops.ring_attention import (
        ring_flash_attention_trainable,
    )

    def ring_fn(qs, ks, vs):
        return ring_flash_attention_trainable(qs, ks, vs, "model",
                                              True), None

    _ring_grads_vs_jax(ring_run, "ring_", lambda out, lse: jnp.sum(out**2),
                       ring_fn)


def test_ring_with_lse_grads_match_jax_ring(ring_run):
    """Cotangents of both outputs (out and lse) through the ring backward:
    dq, dk, dv against JAX's ring_flash_attention_with_lse with the same
    loss."""
    import jax.numpy as jnp

    from mapanything_tpu.ops.ring_attention import (
        ring_flash_attention_with_lse,
    )

    def ring_fn(qs, ks, vs):
        return ring_flash_attention_with_lse(qs, ks, vs, "model", True)

    _ring_grads_vs_jax(
        ring_run, "",
        lambda out, lse: jnp.sum(out**2) + jnp.sum(jnp.sin(lse)), ring_fn)


def test_ring_block_with_token_matches_jax_block(ring_run):
    """RingGlobalBlock (patches sharded, token replicated) against the JAX
    Block on the concatenated [x; tok]: every parameter's gradient, summed
    over ranks, and the gradients of x and tok."""
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.nn.layers import Block as JaxBlock
    from mapanything_tpu_torch.utils.weights import from_jax_params

    run = ring_run
    jblk = JaxBlock(DIM, HEADS, attn_impl="xla")

    def loss(params, x, tok):
        out = jblk.apply(params, jnp.concatenate([x, tok], axis=1))
        return jnp.sum(out[:, :N] ** 2) + jnp.sum(out[:, N:] ** 2)

    with _highest():
        gp, gx, gt = jax.grad(loss, argnums=(0, 1, 2))(
            run["params"], run["x"], run["tok"])
    ref = from_jax_params(jax.tree.map(np.asarray, gp),
                          PL.Block(DIM, HEADS))
    got = run["ranks"][0]
    for r in run["ranks"][1:]:  # the all-reduced gradients agree
        np.testing.assert_array_equal(r["grad.attn.qkv.weight"],
                                      got["grad.attn.qkv.weight"])
    for key, val in ref.items():
        np.testing.assert_allclose(got[f"grad.{key}"], val, err_msg=key,
                                   **GRAD_TOL)
    np.testing.assert_allclose(_cat(run, "dx"), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(got["dtok"], np.asarray(gt), **GRAD_TOL)


def test_ring_entropy_scaling_matches_jax_block(ring_run):
    """RingGlobalBlock with entropy scaling (base 16 over 256 patches and
    the token, sharded over 2 and 4 ranks) against the JAX Block with the
    same base on the concatenated [x; tok]: the patches' and the token's
    outputs, the token's on every rank."""
    import jax.numpy as jnp

    from mapanything_tpu.nn.layers import Block as JaxBlock

    run = ring_run
    seq = jnp.concatenate([run["x"], run["tok"]], axis=1)
    with _highest():
        ref = np.asarray(JaxBlock(
            DIM, HEADS, attn_impl="xla",
            entropy_scaling_base=ENTROPY_BASE).apply(run["params"], seq))
        plain = np.asarray(JaxBlock(DIM, HEADS, attn_impl="xla").apply(
            run["params"], seq))
    assert np.abs(ref - plain).max() > 1e-3  # the scaling took effect
    np.testing.assert_allclose(_cat(run, "entropy_x"), ref[:, :N],
                               **FWD_TOL)
    for r in run["ranks"]:
        np.testing.assert_allclose(r["entropy_tok"], ref[:, N:], **FWD_TOL)


def test_ring_block_without_token_matches_block(ring_run):
    """With no extra token the ring block is the Block over the patches."""
    run = ring_run
    inp = np.load(os.path.join(run["folder"], "inputs.npz"))
    blk = PL.Block(DIM, HEADS)
    blk.load_state_dict({key[6:]: torch.from_numpy(inp[key])
                         for key in inp.files if key.startswith("block.")})
    with torch.no_grad():
        ref = blk(torch.from_numpy(run["x"])).numpy()
    np.testing.assert_allclose(_cat(run, "out_no_token"), ref, **FWD_TOL)
