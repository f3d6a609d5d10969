"""What the benchmark loads: no module of JAX, Flax or the JAX package (top
level names compared whole, since the port's name begins with the JAX
package's), and nothing of the program in the reference."""

import ast
import glob
import os
import subprocess
import sys

from gpubench import harness

REF = os.path.join(harness.HERE, "reference")


def imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(REF, "*.py"))
    assert files
    for path in files:
        tops = {n.split(".")[0] for n in imported_names(path)}
        assert not tops & {"sdm_tpu_torch", *harness.FORBIDDEN}, path


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdm_tpu_torch_fake", sys)
    assert "sdm_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sdm_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"sdm_tpu.fake", "jaxlib"} <= set(harness.forbidden_modules())


def test_everything_the_runs_load_is_free_of_jax():
    """A fresh process loads the harness, every driver, every metric, the
    calibration and the program modules the drivers use."""
    code = """
import glob, os, sys
sys.path.insert(0, %r)
from gpubench import harness, calibrate, trace
for kind in ("drivers", "metrics"):
    for path in glob.glob(os.path.join(harness.HERE, kind, "*.py")):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            harness.load_module(kind, name)
from gpubench.drivers import train_step, serve_http
from gpubench.counters import Counts
import sdm_tpu_torch.serving, sdm_tpu_torch.train.step
from sdm_tpu_torch.kernels import _build
Counts().read()
print(harness.forbidden_modules())
""" % harness.ROOT
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and gpubench/ gives no
    result line and a non-zero exit."""
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "sr256.train_b64", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
