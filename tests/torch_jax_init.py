"""The JAX-side init of the port's parity tests.

The port's `MapAnything` always holds the six geometric-prior encoders, as
the reference checkpoint does; flax creates them only when the views it is
initialised on carry the priors. `init_params` therefore initialises the
JAX model on views that carry every prior, so the tree converts strictly
(utils/weights.py::from_jax_params). Flax's init does not read the input
values, only their shapes.
"""

import jax
import jax.numpy as jnp

from mapanything_tpu.models import images_only_config, jit_init


def prior_views(b: int, v: int, h: int, w: int) -> dict:
    """JAX views (B, V, ...) with an image and every prior."""
    return {
        "img": jnp.zeros((b, v, h, w, 3), jnp.float32),
        "ray_directions_cam": jnp.zeros((b, v, h, w, 3), jnp.float32),
        "depth_along_ray": jnp.ones((b, v, h, w, 1), jnp.float32),
        "camera_pose_quats": jnp.zeros((b, v, 4), jnp.float32).at[
            ..., 3].set(1.0),
        "camera_pose_trans": jnp.zeros((b, v, 3), jnp.float32),
        "is_metric_scale": jnp.ones((b, v), bool),
    }


def init_params(jax_model, h: int, w: int, seed: int = 0):
    """`jit_init` of `jax_model` on one view of h x w with every prior."""
    with jax.default_matmul_precision("highest"):
        return jit_init(jax_model, jax.random.PRNGKey(seed),
                        prior_views(1, 1, h, w), images_only_config())
