import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# ---------------------------------------------------------------------------
# Multi-device test lane: REPRO_FORCE_HOST_DEVICES=N makes the *in-process*
# jax see N virtual CPU devices. XLA reads the flag at backend init, so it
# must land in XLA_FLAGS before jax is first imported — conftest import time
# is the one hook that runs before any test module. CI's second tier-1 job
# sets REPRO_FORCE_HOST_DEVICES=8 and runs the whole suite under it.
# ---------------------------------------------------------------------------
_FORCED = os.environ.get("REPRO_FORCE_HOST_DEVICES")
if _FORCED and ("--xla_force_host_platform_device_count"
                not in os.environ.get("XLA_FLAGS", "")):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_FORCED}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); "
        "skips where there is none")


def require_host_devices(n: int):
    """Skip the calling test unless the session has >= n devices."""
    import jax
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices "
                    f"(run under REPRO_FORCE_HOST_DEVICES={n})")


@pytest.fixture
def mesh_factory():
    """Mesh builder over the (forced) host devices: ``make((2, 4), ("data",
    "model"))`` — skips when the session has fewer devices than the mesh
    needs, so mesh-parametrized tests run fully on the 8-virtual-device CI
    lane and degrade to the 1-device cases elsewhere."""
    def make(shape, axes):
        require_host_devices(math.prod(shape))
        from repro.launch.mesh import make_mesh
        return make_mesh(shape, axes)
    return make


def assert_trees_close_normalized(got, want, rel=1e-5, names=None):
    """Per-leaf scale-normalized comparison: max |a-b| ≤ rel · max|want|.

    Shared by the kernel-gradient and plan-gradient suites so tolerance /
    normalization policy lives in one place.
    """
    import jax
    leaves_g, leaves_w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves_g) == len(leaves_w)
    names = names or [""] * len(leaves_g)
    for name, a, b in zip(names, leaves_g, leaves_w):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, atol=rel,
                                   err_msg=name)


def run_in_subprocess(code: str, n_devices: int = 8, timeout: int = 600):
    """Run a python snippet with a forced host-device count (isolated process
    so the main pytest process keeps its single-device jax)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n_devices}")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture
def subproc():
    return run_in_subprocess
