"""Start-up of every pytest process in this repository: before any test
module is collected, the JAX package's native image decoder
(csrc/sdm_decode.cc, which sdm_tpu/data/native.py builds on first use) is
built, one process at a time under a file lock. Without this, the worker
processes that pytest-xdist starts together all build it into the same
file while collecting tests/test_native_decode.py, and a worker that loads
a half-written library turns the decoder off and skips that file's tests.

sdm_tpu/data/native.py is loaded from its path, so the sdm_tpu package
(and JAX, which tests/conftest.py configures first) is not imported here.
"""

import fcntl
import importlib.util
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    build = os.path.join(ROOT, "csrc", "build")
    os.makedirs(build, exist_ok=True)
    spec = importlib.util.spec_from_file_location(
        "_sdm_tpu_native_build", os.path.join(ROOT, "sdm_tpu", "data",
                                              "native.py"))
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    with open(os.path.join(build, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._build()
