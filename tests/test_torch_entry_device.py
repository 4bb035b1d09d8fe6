"""The port's entry points run on the card unless the caller asks for the
CPU, and the port never imports JAX or the JAX package.

* ``flagship.flagship`` (and through it ``flagship_mpc``) and
  ``convert.cost_params_from_numpy`` default to ``device="cuda"``.  On a
  machine without CUDA a call that names no device raises; it does not
  build CPU tensors.  The other tests pass ``device="cpu"``.
* An AST scan of every module of ``trajoptmpcreference_tpu_torch/`` and of
  ``chip_smoke.py``: no import of ``jax`` or ``trajoptmpcreference_tpu``.
"""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

from trajoptmpcreference_tpu_torch import convert
from trajoptmpcreference_tpu_torch import flagship as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "trajoptmpcreference_tpu_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "trajoptmpcreference_tpu"}


@pytest.mark.parametrize("fn", [F.flagship, convert.cost_params_from_numpy])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _entry_calls():
    eye = np.eye(6)
    return {
        "flagship": lambda: F.flagship(N=4)[1].default_params.Q,
        "flagship_mpc": lambda: F.flagship_mpc(N=4)[1].default_params.Q,
        "cost_params_from_numpy": lambda: convert.cost_params_from_numpy(
            eye, eye, eye, np.zeros(6)).Q,
    }


@pytest.mark.parametrize("name", ["flagship", "flagship_mpc",
                                  "cost_params_from_numpy"])
def test_entry_point_without_device_uses_the_card_or_raises(name):
    call = _entry_calls()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_entry_points_on_the_cpu_when_asked():
    _, cost, solver = F.flagship(N=4, device="cpu")
    assert cost.default_params.Q.device.type == "cpu"
    p = convert.cost_params_from_numpy(np.eye(6), np.eye(6), np.eye(6),
                                       np.zeros(6), device="cpu")
    assert p.xg.device.type == "cpu"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_port_never_imports_jax(rel):
    roots = set(_imported_roots(ROOT / rel))
    assert not roots & FORBIDDEN, (rel, roots & FORBIDDEN)
