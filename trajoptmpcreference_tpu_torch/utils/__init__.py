"""Observability utilities: solver traces, operation accounting, timing."""

from trajoptmpcreference_tpu_torch.utils.flops import cost_analysis
from trajoptmpcreference_tpu_torch.utils.timing import time_fn
from trajoptmpcreference_tpu_torch.utils.trace import SQPTrace, solve_traced

__all__ = ["cost_analysis", "time_fn", "SQPTrace", "solve_traced"]
