"""Test configuration: run on the CPU with 8 virtual devices.

SURVEY.md §4 point 4: multi-device tests run on a forced-8-device CPU mesh.
``--xla_force_host_platform_device_count`` must be in XLA_FLAGS before the
first backend init, so pytest_configure (which runs before any test module
imports jax) re-execs pytest once with the CPU platform and 8 host devices.
Global capture is stopped first so the re-exec'd process inherits the real
stdout.

``pytest -m gpu`` selects the card-only tests (tests/test_gpu.py): that
run stays on the default backend, without the re-exec.
"""

import os
import sys

_REEXEC_FLAG = "DVBT_TEST_REEXEC"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, _REPO_ROOT)


def pytest_configure(config):
    if os.environ.get(_REEXEC_FLAG) == "1":
        return
    if config.getoption("markexpr", "").strip() == "gpu":
        return
    env = dict(os.environ)
    env[_REEXEC_FLAG] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env["XLA_FLAGS"] = flags
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])

    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is not None:
        capman.stop_global_capturing()
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable,
              [sys.executable, "-m", "pytest", *sys.argv[1:]], env)
