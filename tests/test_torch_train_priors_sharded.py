"""The view-sharded train step with every prior (the `pass_through` preset)
on CPU ranks over gloo at p = 2 and p = 4 against JAX's train step ((c) of
tests/test_torch_priors_sharded.py, whose weights, batch and helpers it
reuses): 2 steps on 2 samples x 4 views, at tests/test_torch_seq_parallel.
py's tolerances: loss rtol 1e-4, grad_norm rtol 2e-3, the parameters rtol
5e-3 / atol 5e-5, and the same parameters on every rank.

The reference is JAX's make_train_step, which JAX's own tests hold equal
to its make_view_sharded_train_step (tests/test_seq_parallel.py). JAX's
view-sharded step itself is not run here: over a mesh of virtual CPU
devices it aborted the process in 3 of 8 runs, the XLA CPU runtime's
rendezvous timing out after 40 s with the devices waiting in different
collectives (an all-gather and a collective permute).

JAX is imported inside the fixture only, so the spawned ranks load torch
alone.
"""

import os

import numpy as np
import pytest

from mapanything_tpu_torch.models import tasks as PTasks
from mapanything_tpu_torch.train.seq_parallel import (
    make_view_sharded_train_step,
)
from test_torch_priors_sharded import (  # noqa: F401 (the fixture)
    OPTIM,
    STEPS,
    TINY,
    VIEWS,
    _model,
    _steps,
    run_ranks,
    weights,
)


def _rank(group, folder):
    import torch.distributed as dist

    model = _model(folder)
    step = make_view_sharded_train_step(
        model, PTasks.task_config("pass_through"), group=group)
    np.savez(os.path.join(folder, f"rank{dist.get_rank(group)}.npz"),
             **_steps(model, step, None))


def _jax_steps(params, port):
    """JAX's train step: losses, grad norms and the final parameters in the
    port's order, flat."""
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.data.synthetic import make_synthetic_batch as jbatch
    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from mapanything_tpu.models import tasks as JTasks
    from mapanything_tpu.train import step as JS
    from mapanything_tpu_torch.utils.weights import from_jax_params

    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    with jax.default_matmul_precision("highest"):
        step = jax.jit(JS.make_train_step(jax_model,
                                          JTasks.task_config("pass_through")))
        state = JS.create_train_state(jax_model, params,
                                      JS.OptimConfig(**OPTIM))
        batch = jbatch(2, VIEWS, 28, 28, seed=22)
        losses, norms = [], []
        for _ in range(STEPS):
            state, metrics = step(state, batch, jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    final = from_jax_params(jax.tree.map(np.asarray, state.params), port)
    return {"losses": np.asarray(losses), "norms": np.asarray(norms),
            "params": np.concatenate([np.asarray(final[n]).ravel()
                                      for n, _ in port.named_parameters()])}


@pytest.fixture(scope="module")
def jax_ref(weights):
    _, params, port = weights
    return _jax_steps(params, port)


_RANKS = {}


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_preset_step_matches_jax(weights, jax_ref, p):
    ref = jax_ref
    ranks = run_ranks(_RANKS, p, weights, _rank)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["norms"], ref["norms"], rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(rank["params"], ref["params"], rtol=5e-3,
                                   atol=5e-5)
        np.testing.assert_array_equal(rank["params"], ranks[0]["params"])
