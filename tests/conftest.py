"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding
paths (mesh collectives, sharded index) execute without accelerators.
Without JAX_PLATFORMS the platform is pinned to the CPU.  Tests that
only a GPU can run carry the `gpu` marker and skip elsewhere (see the
`gpu_device` fixture); on a GPU host run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU")
    return gpus[0]
