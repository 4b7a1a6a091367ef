"""The numbers that decide `correct`, and the judgement against limits.

A cell's limits live in perfbench/limits/<cell>.json: for each compared
number its "limit", and the "lower" (the largest a dozen or more sound
runs of the program gave) and "upper" (the smallest the control gave)
readings it was set between. A run is correct when every number is finite
and at most its limit.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

LIMITS_DIR = Path(__file__).resolve().parent.parent / "limits"


def rel_l2(got: torch.Tensor, ref: torch.Tensor,
           where: torch.Tensor | None = None) -> float:
    """||got - ref|| / ||ref|| in float64, over the elements where `where`
    (broadcast over trailing axes) holds."""
    got, ref = got.double(), ref.double()
    diff = got - ref
    if where is not None:
        w = where.reshape(where.shape + (1,) * (ref.dim() - where.dim()))
        diff, ref = diff * w, ref * w
    return float(torch.linalg.vector_norm(diff)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-30))


def mismatch(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of elements of two bool tensors that differ."""
    return float((got != ref).double().mean())


def over_floor(gaps: dict, floor: dict | None, least: float = 1e-6) -> dict:
    """Each gap over its floor (at least `least`); a gap without a floor
    as it is."""
    floor = floor or {}
    return {key: gap / max(floor[key], least) if key in floor else gap
            for key, gap in gaps.items()}


def worst(readings: list[dict]) -> dict:
    """Each number's largest reading over several compared calls."""
    return {key: max(r[key] for r in readings) for key in readings[0]}


def load_limits(cell: str) -> dict:
    path = LIMITS_DIR / f"{cell}.json"
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": reading, "limit": limit}}). A number
    without a limit, or a limit without a number, is not correct."""
    checks, ok = {}, bool(readings)
    for name in sorted(set(readings) | set(limits)):
        value = readings.get(name, math.nan)
        limit = limits.get(name, {}).get("limit", math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
