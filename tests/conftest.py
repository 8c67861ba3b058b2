"""Shared test fixtures.

Multi-device meshes on a CPU host need
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set BEFORE jax
initializes its backends (the `repro.launch.mesh.make_debug_mesh`
contract: the flag lives in the test process, never globally).  conftest
imports before any test module, so setting it here covers every
collected test; an externally provided device-count flag (e.g. a CI leg
exporting its own) is respected.

The 512-device production-mesh flag stays confined to the
`test_dryrun.py` SUBPROCESS — 8 host devices is the ceiling for
in-process tests.
"""

import os

_DEVICE_FLAG = "--xla_force_host_platform_device_count=8"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " " + _DEVICE_FLAG).strip()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips in its body "
        "where torch sees none (run on the card with `pytest -m gpu`)")


@pytest.fixture(scope="session")
def make_model_mesh():
    """Factory fixture: ``make_model_mesh(k)`` returns a 1-D mesh with a
    k-device ``model`` axis (skipping if the host exposes fewer devices
    — e.g. when an external XLA_FLAGS pinned a smaller count)."""
    import jax

    from repro.launch.mesh import make_debug_mesh

    def make(k: int):
        if len(jax.devices()) < k:
            pytest.skip(f"needs {k} host devices, have "
                        f"{len(jax.devices())}")
        return make_debug_mesh((k,), ("model",))

    return make
