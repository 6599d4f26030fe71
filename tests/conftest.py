import os

import pytest

# Simulate an 8-device mesh on CPU for the sharding tests (SURVEY.md §4d).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-process tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips elsewhere (run on the card "
        "with `python -m pytest tests -m gpu`)")


@pytest.fixture
def gpu_device():
    """The first CUDA GPU, decided when the test runs (never at import):
    tests marked ``gpu`` take this fixture and skip without a card."""
    import jax
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a CUDA GPU")
    return devices[0]
