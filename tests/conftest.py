"""Test environment: CPU backend with a virtual 8-device mesh, x64 on.

Swarm-level parallelism is validated on host CPU devices
(``xla_force_host_platform_device_count``); the sharding code paths are
identical on GPUs.  Tests that need an NVIDIA GPU carry the ``gpu`` marker
and the ``gpu`` fixture, which skips them elsewhere; run them on a GPU host
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import os
import pathlib

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# The reference checkout (LightDock-Rust, with its example/ inputs and
# outputs); tests that need it skip when LIGHTDOCK_REFERENCE is unset.
REFERENCE = os.environ.get("LIGHTDOCK_REFERENCE")


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    if not REFERENCE or not pathlib.Path(REFERENCE).exists():
        pytest.skip("reference data not available (set LIGHTDOCK_REFERENCE)")
    return pathlib.Path(REFERENCE)


@pytest.fixture(scope="session")
def goldens_dir() -> pathlib.Path:
    return pathlib.Path(__file__).parent / "goldens"


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided here, at run time,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/test_gpu.py")
