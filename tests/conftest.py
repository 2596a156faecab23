"""Test configuration: force CPU backend with 8 virtual devices.

This is the TPU build's analog of the reference's multi-platform CI matrix
(SURVEY.md section 4): the same suite runs on the CPU lowering everywhere,
with an 8-device virtual mesh standing in for a pod slice so the shard_map/
collective paths are executed, not just traced. Bench runs (bench.py) use
the real TPU chip instead.
"""

import os

# Must happen before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Belt and braces: if a pytest plugin imported jax before this conftest ran,
# the env vars above were read too late — force the platform via config.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # float64 references in tests

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc; skips without them "
        "(on the card: python -m pytest -m cuda tests/test_torch_cuda.py)",
    )
