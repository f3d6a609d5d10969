"""The port stands alone: sdm_tpu_torch and chip_smoke.py import neither JAX
(nor flax) nor anything of sdm_tpu, and chip_smoke.py refuses to run where
there is no CUDA device or no repository around it."""

import os
import pkgutil
import shutil
import subprocess
import sys

import sdm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sdm_tpu_torch.__path__, prefix="sdm_tpu_torch."))


def test_port_imports_no_jax_and_no_sdm_tpu():
    modules = _port_modules()
    for name in ("serving.engine", "train.step", "train.loop",
                 "data.datasets", "data.loader", "data.tinydb_compat",
                 "utils.logging_setup", "utils.profiling",
                 "cli.train_diffusion", "cli.train_SR_diffusion",
                 "cli.train_noise_cold_diffusion",
                 "cli.train_doodle_diffusion",
                 "cli.generate_images_diffusion", "cli.config_wizards",
                 "cli.create_diffusion_config",
                 "cli.create_sr_diffusion_config",
                 "cli.create_doodle_diffusion_config", "cli.export_models",
                 "kernels._autograd", "diffusion.vpred",
                 "diffusion.guidance", "diffusion.samplers",
                 "cli.generate_images_cold_diffusion",
                 "cli.serve_diffusion", "train.distill",
                 "cli.distill_diffusion", "eval.fid", "eval.features",
                 "cli.evaluate_samples", "parallel", "parallel.multihost",
                 "parallel.mesh", "parallel.fsdp", "parallel.pipeline",
                 "parallel.tp", "parallel.sp", "parallel.analysis",
                 "parallel._comm", "io.native_ckpt", "data.native",
                 "utils.progress"):
        assert f"sdm_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'sdm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sdm_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_only_the_wizards_import_click():
    """The chip machine has no click: chip_smoke.py and every port module
    but the config wizards import without it (the export prompt imports it
    when it runs)."""
    wizards = ("sdm_tpu_torch.cli.config_wizards",
               "sdm_tpu_torch.cli.create_")
    modules = [m for m in _port_modules() if not m.startswith(wizards)]
    assert "sdm_tpu_torch.cli.export_models" in modules
    code = (
        "import sys\n"
        "sys.modules['click'] = None\n"
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _last_line_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and '"ok": true' in lines[-1]


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not _last_line_ok(out.stdout)


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not _last_line_ok(out.stdout)
