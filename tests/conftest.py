"""Test harness: force an 8-device CPU platform so sharded paths are testable
without several cards (SURVEY §4 — the multi-device coverage the reference
lacks). Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them here."""

import os

# must happen before jax initializes a backend; the config update after the
# import keeps the chosen platform even where a plugin registers another one.
# CPU unless the caller names another (JAX_PLATFORMS=cuda for the gpu tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream no matter
    # which other tests ran before it (a session-scoped stream made marginal
    # SNR asserts order-dependent)
    return np.random.RandomState(11110)


@pytest.fixture()
def gpu():
    """The GPU devices, for tests marked ``gpu``; skips where JAX finds none.
    Decided here, at run time, never while modules are imported: every xdist
    worker must collect the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {devices[0].platform}")
    return devices
