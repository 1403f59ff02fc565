"""Test environment: the CPU, with an 8-device virtual mesh.

Multi-chip code paths (shard_map over a Mesh) are exercised on virtual
CPU devices. Tests run on the CPU unless JAX_PLATFORMS says otherwise:
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests` runs the tests
marked `gpu` on a card. Must run before jax initializes.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may already be imported (before this file) by the interpreter's
# site start-up, so the environment variable alone can be too late; the
# backends are not initialized yet, so pinning the config still works
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_scene():
    """The minimum end-to-end fixture: Cornell box (SURVEY.md §7.2) —
    diffuse walls, one positional sphere light, perspective camera.
    Mirrors data/scripts/CornellBox.tcl:10-37 minus the glass objects."""
    from cadrays_tpu.testing.scenes import cornell_box

    return cornell_box()


@pytest.fixture(scope="session")
def cornell_camera():
    from cadrays_tpu.testing.scenes import cornell_camera as cam

    return cam()
