"""Test harness config: force JAX onto a simulated 8-device CPU mesh.

SURVEY.md §4.2: multi-device sharding logic is tested on CPU with a forced
8-device host platform, so the suite runs the same with or without a GPU.
The live jax config is overridden as well as the environment variable, in
case jax was imported before this file (backends init lazily at first
device use, which is after conftest import).

Tests that only the GPU can run carry the ``gpu`` marker, take the
``gpu_backend`` fixture (which skips them, with a reason, where JAX finds no
GPU) and drive the GPU from a child process, since this process stays on
the CPU: ``python -m pytest tests/test_chip_smoke.py -m gpu`` on a machine
with a GPU (other test modules need gymnasium, which the GPU machine may
lack).
"""

import os
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu_backend():
    """Skip unless a child JAX process (free of this file's CPU forcing)
    finds a GPU.  Decided inside the fixture, never at import, so every
    xdist worker collects the same tests."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    backend = probe.stdout.strip().splitlines()[-1:] or ["none"]
    if backend != ["gpu"]:
        pytest.skip(f"needs a GPU; a child JAX process found {backend[0]!r}")


@pytest.fixture(scope="session", autouse=True)
def _verify_cpu_backend():
    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8


@pytest.fixture(scope="session", autouse=True)
def _reference_resurvey_tripwire():
    """SURVEY.md §0 protocol: all parity claims target the in-repo oracle
    because /root/reference was EMPTY at survey time.  If the mount is ever
    populated, that premise is void — fail loudly so the next session
    re-surveys and reconciles every VERIFY tag in SURVEY.md §2.1 before
    trusting any parity result."""
    ref = "/root/reference"
    if os.path.isdir(ref) and os.listdir(ref):
        pytest.fail(
            f"{ref} is now NON-EMPTY ({len(os.listdir(ref))} entries) but "
            "the oracle spec was built against an empty mount — re-survey "
            "required (SURVEY.md §0, VERDICT.md round 1 missing #4) before "
            "any parity claim is valid.",
            pytrace=False,
        )
