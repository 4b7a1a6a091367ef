"""The training step's CUDA graph on the card (train/step.py::
make_train_step): a small bf16 MapAnything under the aug_training mix of
priors, its masks drawn from a seeded CUDA generator.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one.

Four runs of the same seven steps from the same init, batches of 1 x 2
and 1 x 3 views in turn as a loader's buckets come (2, 2, 3, 3, 2, 3, 2
views): the graphed run (the step as the program takes it: each shape
eager, then captured, then replayed, the two graphs replayed in another
order than they were captured) and three eager runs (each step given a
new generator object in the running generator's state, so that every
signature is new). The
forward is deterministic and step 0 runs at lr 0, so the losses of steps
0 and 1 (the first replay, captured) are the eager steps' bits. The
backward is not (atomic sums), and from step 1 on the eager path's own
runs drift apart, now and then by a jump of ~3e-3 in a step's gradient
norm (an H100 showed such jumps in graphed and eager runs alike, from
identical states). So the graphed run is held to the first eager run
within ten times the largest gap between two eager runs, over the final
parameters and moments and over the steps' losses and gradient norms: a
stale input, a wrong mask draw or a stale learning rate moves them by
orders of magnitude more. Besides: the counter of captures, replays and eager
steps; a step's metrics unchanged by the next step; one "train.graph"
span and no eager span a replay; the attention kernels launched from the
host by the eager steps and the captures, and none by a replay, whose
device trace runs them all; no host synchronisation in an eager step or a
replay (torch.cuda.set_sync_debug_mode("error")); a replay after forwards
at twenty other sizes and the allocator's blocks overwritten still reads
its device constants (utils/device.py::device_constant); and a caller's
autograd graph that holds the parameters' accumulators makes the capture
fail with a clear error (last: it leaves a failed capture behind).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
    images_only_config,
)
from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.perf.timing import trace_kernel_counts
from mapanything_tpu_torch.train import step as PS

TINY = dict(encoder_size="small", patch_size=14, trunk_dim=384,
            trunk_depth=4, trunk_num_heads=6, trunk_indices=(1, 2),
            dpt_feature_dim=64, dpt_out_channels=(64, 64, 64, 64),
            dpt_hidden_dims=(32, 16))
INIT_SEED, MASK_SEED = 3, 11
H, W = 112, 140  # 8 x 10 patches
SHAPES = [(v, k) for k, v in enumerate((2, 2, 3, 3, 2, 3, 2))]
REPLAYS = (4, 5, 6)  # the steps that replay a graph
FIRST_REPLAY = 1
# the training kernels by their names in a device trace
KERNELS = {"fwd_lse": "flash_fwd_sm90", "dkv": "flash_bwd_dkv_sm90",
           "dq": "flash_bwd_dq_sm90"}
DRIFT = 10.0


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test replays the training "
                    "step's CUDA graph")
    return torch.device("cuda")


def _state(**optim):
    model = MapAnything(MapAnythingConfig(**TINY), generator=torch.Generator(
        device="cuda").manual_seed(INIT_SEED))
    return model, PS.create_train_state(
        model, PS.OptimConfig(warmup_steps=2, total_steps=100, **optim))


def _eager_step(step, state, batch, gen):
    """step(state, batch, gen) with a new generator object in gen's state,
    so that the step runs eagerly; gen takes the state it leaves."""
    g = torch.Generator(device="cuda")
    g.set_state(gen.get_state())
    state, m = step(state, batch, g)
    gen.set_state(g.get_state())
    return state, m


def _run(graphed: bool) -> dict:
    """The seven steps; what each step returned and launched, the final
    parameters and moments, and the step's counter."""
    model, state = _state()
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    out = {"metrics": [], "kept": [], "launches": []}
    for i, (views, seed) in enumerate(SHAPES):
        batch = make_synthetic_batch(1, views, H, W, seed=seed, device="cuda")
        fa.reset_launch_counts()
        if graphed:
            state, m = step(state, batch, gen)
        else:
            state, m = _eager_step(step, state, batch, gen)
        out["launches"].append(dict(fa.flash_attention.kernel_counts))
        out["metrics"].append(m)
        out["kept"].append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    opt = state.optimizer
    out["final"] = {key: torch.cat([t.detach().flatten() for t in tensors])
                    for key, tensors in (("params", opt.params),
                                         ("mu", opt.mu), ("nu", opt.nu))}
    out["counts"] = dict(step.counts)
    out["step"], out["count"] = state.step, opt.count
    return out


@pytest.fixture(scope="module")
def runs(cuda_device):
    return {"graph": _run(True), "eager": [_run(False) for _ in range(3)]}


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _own(eager: list, pick) -> float:
    """The eager path's own rounding of what `pick` reads from a run: the
    largest gap between two of its runs."""
    return max(_gap(pick(a), pick(b)) for i, a in enumerate(eager)
               for b in eager[i + 1:])


@pytest.mark.cuda
def test_the_graph_engages_and_recaptures_at_a_new_shape(runs):
    # each shape eager, then captured (and replayed once), then replayed:
    # 2 views twice more, 3 views once more
    assert runs["graph"]["counts"] == {"captures": 2, "replays": 3,
                                       "eager": 2}
    for eager in runs["eager"]:
        assert eager["counts"] == {"captures": 0, "replays": 0, "eager": 7}
    assert runs["graph"]["step"] == runs["graph"]["count"] == len(SHAPES)


@pytest.mark.cuda
def test_the_first_replays_loss_is_the_eager_steps(runs):
    graph, eager = runs["graph"], runs["eager"]
    for run in [graph, *eager[1:]]:
        for i in range(FIRST_REPLAY + 1):
            assert torch.equal(run["kept"][i]["loss"],
                               eager[0]["kept"][i]["loss"]), i


@pytest.mark.cuda
def test_graphed_steps_stay_within_the_eager_paths_drift(runs):
    graph, eager = runs["graph"], runs["eager"]
    for key in ("params", "mu", "nu"):
        own = _own(eager, lambda run: run["final"][key])
        got = _gap(graph["final"][key], eager[0]["final"][key])
        assert got <= DRIFT * own, (key, got, own)
    steps = range(len(SHAPES))
    for key in ("loss", "grad_norm"):
        own = max(_own(eager, lambda run: run["kept"][i][key]) for i in steps)
        got = [_gap(graph["kept"][i][key], eager[0]["kept"][i][key])
               for i in steps]
        assert all(torch.isfinite(graph["kept"][i][key]) for i in steps)
        assert max(got) <= DRIFT * own, (key, got, own)


@pytest.mark.cuda
def test_a_steps_metrics_are_its_own(runs):
    """Step k's metrics, read after every later step, are still step k's."""
    for ran in [runs["graph"], *runs["eager"]]:
        for m, kept in zip(ran["metrics"], ran["kept"]):
            assert m.keys() == kept.keys()
            for key in m:
                assert torch.equal(m[key], kept[key]), key
    losses = [float(k["loss"]) for k in runs["graph"]["kept"]]
    assert len(set(losses)) == len(losses)


@pytest.mark.cuda
def test_the_host_launches_the_eager_and_captured_steps_kernels(runs):
    """Each eager or captured step counts, from the host, one forward with
    lse, one dK/dV and one dQ launch per attention of its shape; a replay
    counts none (its launches are the graph's: next test)."""
    graph, eager = runs["graph"], runs["eager"][0]
    for i, (launches, want) in enumerate(zip(graph["launches"],
                                             eager["launches"])):
        assert want["fwd_lse"] > 0 and want["fwd"] == 0
        assert want["fwd_lse"] == want["dkv"] == want["dq"]
        if i in REPLAYS:
            assert not any(launches.values()), i
        else:
            assert launches == want, i


@pytest.mark.cuda
def test_a_replay_runs_its_attention_kernels_on_the_card(cuda_device):
    """A replay's device trace holds, by name, one forward with lse, one
    dK/dV and one dQ kernel per attention: what the eager step launches
    from the host at the same shape."""
    model, state = _state()
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cuda")
    fa.reset_launch_counts()
    state, _ = step(state, batch, gen)  # eager: the warm-up
    want = {key: fa.flash_attention.kernel_counts[key] for key in KERNELS}
    state, _ = step(state, batch, gen)  # captured and replayed
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)  # replayed
        torch.cuda.synchronize()
    assert step.counts == {"captures": 1, "replays": 1, "eager": 1}
    assert not any(fa.flash_attention.kernel_counts.values())
    found = trace_kernel_counts(prof, KERNELS.values())
    assert {key: found[name] for key, name in KERNELS.items()} == want
    assert want["fwd_lse"] > 0


@pytest.mark.cuda
def test_a_replay_is_one_span_and_syncs_nothing(cuda_device):
    model, state = _state()
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cuda")
    state, _ = step(state, batch, gen)  # eager: the warm-up
    state, _ = step(state, batch, gen)  # captured and replayed
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = step(state, batch, gen)  # replayed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, batch, gen)  # replayed
        g = torch.Generator(device="cuda")
        g.set_state(gen.get_state())
        state, _ = step(state, batch, g)  # a new generator: eager
    finally:
        torch.cuda.set_sync_debug_mode("default")
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names.count("train.graph") == 1
    assert not {"train.forward", "train.loss", "train.backward",
                "train.optimizer"} & set(names)
    assert step.counts == {"captures": 1, "replays": 2, "eager": 2}
    assert torch.isfinite(m["loss"])


@pytest.mark.cuda
def test_a_replay_reads_its_constants_after_other_sizes(cuda_device):
    """At lr 0 the parameters stay as they are, so each step's loss is the
    forward's alone, the same bits eager or replayed. Between the capture
    and the replay, forwards at twenty other sizes make more device
    constants (RoPE tables, DINOv2's resize matrices) than a bounded cache
    would keep, and tensors filled with NaN take the allocator's free
    blocks: the replay's loss is still the eager step's."""
    model, state = _state(lr=0.0)
    graphed = PS.make_train_step(model, aug_training_config())
    eager = PS.make_train_step(model, aug_training_config())
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cuda")
    losses = {}
    for name in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
        losses[name] = []
        for i in range(3):
            if name == "eager":
                state, m = _eager_step(eager, state, batch, gen)
            else:
                state, m = graphed(state, batch, gen)
            losses[name].append(m["loss"].clone())
            if name == "graph" and i == 1:
                with torch.no_grad():
                    for k in range(1, 21):
                        views = make_synthetic_batch(
                            1, 2, 14 * (4 + k % 5), 14 * (4 + k // 5),
                            seed=k, device="cuda")["views"]
                        model(views, images_only_config())
                junk = [torch.full((n,), float("nan"), device="cuda")
                        for n in (2 ** e for e in range(8, 22))
                        for _ in range(4)]
                del junk
    assert graphed.counts == {"captures": 1, "replays": 1, "eager": 1}
    for got, want in zip(losses["graph"], losses["eager"]):
        assert torch.isfinite(got) and torch.equal(got, want)


@pytest.mark.cuda
def test_a_callers_graph_on_the_default_stream_fails_the_capture_clearly(
        cuda_device):
    """A caller's forward and backward on the default stream whose loss
    details stay alive hold the parameters' gradient accumulators on the
    legacy stream, where CUDA refuses a capture: the step's capture raises
    RuntimeError naming that cause, from CUDA's own error."""
    model, state = _state()
    step = PS.make_train_step(model, aug_training_config())
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cuda")
    loss, details = PS.make_loss_fn(model, aug_training_config())(batch, gen)
    loss.backward()
    del loss
    for p in model.parameters():
        p.grad = None
    state, m = step(state, batch, gen)  # eager: the warm-up
    with pytest.raises(RuntimeError, match="CUDA refused to capture") as err:
        step(state, batch, gen)
    assert err.value.__cause__ is not None
    assert step.counts == {"captures": 0, "replays": 0, "eager": 1}
    del details
