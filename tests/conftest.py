"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 device; anything
multi-device runs in a subprocess (helpers below)."""
import os
import subprocess
import sys
import textwrap

import pytest


def run_multidevice(script: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run `script` in a fresh python with n fake devices; return stdout.

    Scripts are written against the modern jax sharding API; the preamble
    backfills it on older jax (repro.dist.compat)."""
    preamble = "from repro.dist.compat import install as _i; _i()\n"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", preamble + textwrap.dedent(script)],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the Hopper kernels have no CPU mode); "
        "the test skips itself without one",
    )
