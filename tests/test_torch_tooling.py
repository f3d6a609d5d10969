"""The port's tooling against sdm_tpu's: the progress bar
(sdm_tpu_torch/utils/progress.py) prints what sdm_tpu's prints, and the
profiler context (utils/profiling.py::trace) does nothing without a
directory, as sdm_tpu's does."""

import pytest

from sdm_tpu.utils import print_progress_bar as jax_bar
from sdm_tpu_torch.utils import print_progress_bar
from sdm_tpu_torch.utils.profiling import trace


def _printed(fn, *args, **kwargs):
    calls = []
    fn(*args, log=lambda *a, **k: calls.append((a, k)), **kwargs)
    return calls


@pytest.mark.parametrize("iteration,total,kwargs", [
    (0, 10, {}), (3, 7, dict(prefix="Epoch", suffix="done", decimals=2)),
    (10, 10, dict(length=20, fill="#")), (5, 10, dict(print_end="\n"))])
def test_progress_bar_prints_what_sdm_tpu_prints(iteration, total, kwargs):
    got = _printed(print_progress_bar, iteration, total, **kwargs)
    assert got == _printed(jax_bar, iteration, total, **kwargs)
    assert len(got) == (2 if iteration == total else 1)


@pytest.mark.parametrize("logdir", [None, ""])
def test_trace_without_a_directory_does_nothing(tmp_path, logdir):
    with trace(logdir) as prof:
        assert prof is None
