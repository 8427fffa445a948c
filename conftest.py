"""Repository-wide pytest setup, loaded before ``tests/conftest.py``.

``safeopt_tpu.native`` builds ``csrc/libhostfactor.so`` with ``g++`` at
its first use, writing straight to the final path, and the library is
not committed. Under ``pytest -n`` every worker imports the test modules
at once, and a worker that finds the library half written fails to load
it and skips ``tests/test_native.py``. The controller builds it here,
once, before any worker starts, loading the module by its file path so
that this process does not import JAX.
"""

import importlib.util
import os


def pytest_configure(config):
    """Build the native library once, in the controller (or the only
    process), before any test module is imported."""
    if hasattr(config, "workerinput"):          # an xdist worker
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "safeopt_tpu", "native", "__init__.py")
    spec = importlib.util.spec_from_file_location("_native_prebuild", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.available()
