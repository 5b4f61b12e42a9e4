"""Test configuration.

Tests run on CPU with an 8-device virtual mesh so every sharding code
path (SURVEY.md §5.8) executes without accelerator hardware.  Must set
the env vars before the first `import jax` anywhere in the process.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and the
``gpu_device`` fixture, which skips them unless JAX's backend is the
GPU; ``chip_smoke.py`` runs them on the card.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Persistent on-disk XLA executable cache, with the same path rule as
# the CLI tools (utils/jax_cache.py): the suite's wall time is
# dominated by XLA:CPU compiles of the mapper programs, which are
# identical from worker to worker and from run to run.
from nvbio_tpu.utils.jax_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache(min_compile_secs=0.5)

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none.  The
    decision is made here, per test, never while modules import."""
    devs = [d for d in jax.devices() if d.platform == "gpu"] \
        if jax.default_backend() == "gpu" else []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return devs[0]
