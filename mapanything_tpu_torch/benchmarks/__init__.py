"""Benchmark harnesses: dense N-view, calibration (and benchmarks/rmvd.py,
the RMVD adaptor); counterparts of mapanything_tpu/benchmarks."""

from .calibration import ray_angular_error_deg, run_calibration_benchmark
from .dense_n_view import (
    compute_metrics_for_batch,
    run_dense_n_view_benchmark,
)

__all__ = [
    "compute_metrics_for_batch",
    "ray_angular_error_deg",
    "run_calibration_benchmark",
    "run_dense_n_view_benchmark",
]
