"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — smoke tests and
benchmarks must see the real single CPU device; multi-device tests spawn
subprocesses with their own flags (see helpers.run_subprocess)."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:                                    # real hypothesis when installed …
    import hypothesis  # noqa: F401
except ModuleNotFoundError:             # … else the deterministic shim
    try:
        import _mini_hypothesis as _mh          # tests/ on sys.path
    except ModuleNotFoundError:
        from tests import _mini_hypothesis as _mh  # repo root on sys.path

    sys.modules["hypothesis"] = _mh
    sys.modules["hypothesis.strategies"] = _mh.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel on an NVIDIA GPU; skips on a "
        "machine without one")


def run_py(code: str, devices: int = 0, timeout: int = 600) -> str:
    """Run a python snippet in a subprocess (optionally with N fake
    devices) and return stdout.  Raises on nonzero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    if devices:
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_py
