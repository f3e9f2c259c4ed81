import os

# Tests run on the single host device (smoke configs). The 512-device
# virtualization is ONLY for the dry-run (repro/launch/dryrun.py) and the
# subprocess-based mesh tests, which set XLA_FLAGS themselves.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running system test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA kernels); skips elsewhere")


@pytest.fixture(scope="session")
def executor():
    from repro.core import Executor
    ex = Executor(domains={"host": 4})
    yield ex
    ex.shutdown(wait=False)
