"""On the card only (marked `cuda`; decided inside each test): one short
run of the flagship serving cell through run.py comes out correct, and
the control, the reference computed in float8, fails the cell's limit at the
cell's own size. Run on the card with

    python3 -m pytest gpubench/tests/test_gpubench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from gpubench import harness

CELL = "flagship128.serve_mixed"


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels are CUDA only")


@pytest.mark.cuda
def test_short_run_is_correct():
    need_card()
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          CELL, "--seed", str(2 ** 31 + 5), "--seconds",
                          "10", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_fails_the_limit():
    need_card()
    import torch
    from gpubench import calibrate
    spec = harness.cell_spec(CELL)
    harness.cache_env()
    checks = calibrate.serve_control(spec, 2 ** 31 + 6,
                                     torch.device("cuda"))
    assert not harness.judge(checks), checks
    assert os.path.isdir(harness.HERE)
