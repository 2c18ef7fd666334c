import os

# Keep the default single CPU device for unit tests (the dry-run sets its own
# 512-device flag in its own process).  Cap compile threads for the 1-core box.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full simulation sweeps, large cohorts)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full simulation sweeps / large cohorts; skipped unless --runslow",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); "
        "skips inside the test where torch.cuda.is_available() is False",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow simulation sweep: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
