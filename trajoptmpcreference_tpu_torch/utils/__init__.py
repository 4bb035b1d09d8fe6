"""Observability utilities: solver traces, operation accounting, timing,
and the port's own spans and counters (``utils.spans``).

The names below load on first use: ``utils.spans`` is imported by the ops
and solver modules, and ``utils.trace`` imports the solvers, so importing
this package must not import them."""

import importlib

_HOME = {"cost_analysis": "flops", "time_fn": "timing",
         "SQPTrace": "trace", "solve_traced": "trace"}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
