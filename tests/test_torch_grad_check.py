"""train/grad_check.py on the tiny model, on the CPU.

On CPU tensors "auto" runs the flash Function's plain twins (the explicit
backward formulas) and "math" runs torch autograd of plain attention, both
in fp32. The loss and the gradients pulled back from the shared cotangent
are held to fp32 rounding, 1e-5. A single term's gradient is smaller than
the total's and its parts cancel, so its relative rounding grows: 1e-3,
still far below the O(1) of a wrong backward. Where the loss branches (the
exclude-top-N% ranking, the quaternion double cover) a term may flip under
fp32 rounding too, so those terms and the total are only held to be
finite. `term_losses` must add up to the total (it raises otherwise), with
the 2 / n_views scaling above two views.
"""

import math

import pytest
import torch

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.train.grad_check import compare, term_losses
from mapanything_tpu_torch.train.losses import overall_loss

H, W = 28, 42  # 2 x 3 patches of 14
_SLICE_CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
                  trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
                  dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
_TERMS = {"total", "pts3d (conf)", "cam_pts3d (exclude top)",
          "depth_along_ray (exclude top)", "ray_directions", "pose_quats",
          "pose_trans", "scale", "normal", "gradient_matching",
          "non_ambiguous_mask"}


def _model():
    return MapAnything(
        MapAnythingConfig(dtype=torch.float32, **_SLICE_CFG),
        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("views", [1, 3])
def test_terms_add_up_to_the_total(views):
    batch = make_synthetic_batch(1, views, H, W, seed=views)
    with torch.no_grad():
        preds = _model()({"img": batch["views"]["img"]})
    loss, details = overall_loss(batch["gt"], preds)
    terms = term_losses(details, views)
    assert set(terms) == _TERMS - {"total"}
    total = sum(terms.values())
    assert abs(float(total - loss)) <= 1e-5 * abs(float(loss))


def test_flash_matches_math_on_cpu():
    res = compare(_model(), make_synthetic_batch(1, 2, H, W, seed=0))
    assert res["loss_rel_diff"] <= 1e-5
    assert res["grad_rel_l2"] <= 1e-5
    assert res["qkv_grad_rel_l2"] <= 1e-5
    assert set(res["terms"]) <= _TERMS and "total" in res["terms"]
    branching = {"total", "cam_pts3d (exclude top)",
                 "depth_along_ray (exclude top)", "pose_quats"}
    for name, term in res["terms"].items():
        assert math.isfinite(term["flash_rel_l2"]), name
        assert math.isfinite(term["noise_floor_rel_l2"]), name
        if name not in branching:
            assert term["flash_rel_l2"] <= 1e-3, name
    assert res["full_loss_grad_noise_floor"] > 0.0
    assert res["grad_noise_floor_rel_l2"] > res["grad_rel_l2"]
    assert res["qkv_grad_noise_floor_rel_l2"] > res["qkv_grad_rel_l2"]
