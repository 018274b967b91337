"""The ``restore_sanitizers`` fixture for the port's tests (not a test
file): ``runtime.deterministic`` and ``runtime.debug_nans`` turn on
process-wide modes, in the port (``runtime/sanitize.py``) as in the JAX
package (``jax_debug_nans``). A test that turns one on imports the
fixture, which puts every such flag back as it found it."""

import os

import jax
import pytest
import torch

from orion_tpu_torch.runtime import sanitize


@pytest.fixture
def restore_sanitizers():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"), sanitize.debug_nans(),
              jax.config.jax_debug_nans)
    yield
    det, warn_only, cudnn_det, cudnn_bench, ws, nans, jax_nans = before
    torch.use_deterministic_algorithms(det, warn_only=warn_only)
    torch.backends.cudnn.deterministic = cudnn_det
    torch.backends.cudnn.benchmark = cudnn_bench
    if ws is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ws
    sanitize.set_debug_nans(nans)
    jax.config.update("jax_debug_nans", jax_nans)
