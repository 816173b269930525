"""Test harness config.

Tests run on the CPU backend with 8 virtual devices so sharding paths are
exercised without accelerator hardware.  Must run before anything
imports jax.
"""

import os

# Force, not setdefault: a machine with an accelerator would otherwise
# hand the tests its devices instead of the virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
SYNTH_FIXTURE = os.path.join(REFERENCE_DIR, "gps_sig_tmp.bin")


@pytest.fixture(scope="session")
def synth_fixture_path():
    if not os.path.exists(SYNTH_FIXTURE):
        pytest.skip("reference synthetic capture not available")
    return SYNTH_FIXTURE


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
