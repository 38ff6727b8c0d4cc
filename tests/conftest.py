import os

# Tests run on the CPU with a virtual 8-device mesh, so the multi-device
# sharding paths compile and execute without accelerators (SURVEY.md
# section 4).  A run on the card sets JAX_PLATFORMS itself
# (JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def golden_dir():
    return os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def gpu():
    """The first GPU.  Whether there is one is decided here, when a
    test runs -- never while test modules are imported, so every xdist
    worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/ on the card")
    return gpus[0]


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end test")
    config.addinivalue_line("markers", "gpu: needs a GPU; skips without one")
