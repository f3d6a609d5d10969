"""Terminal progress bar (the port's own copy of
sdm_tpu/utils/progress.py::print_progress_bar, the reference's
utils/utils.py:8-36), for host-side loops."""

from __future__ import annotations


def print_progress_bar(iteration, total, prefix="", suffix="", decimals=1,
                       length=100, fill="█", print_end="\r", log=print):
    percent = ("{0:." + str(decimals) + "f}").format(
        100 * (iteration / float(total)))
    filled = int(length * iteration // total)
    bar = fill * filled + "-" * (length - filled)
    log(f"\r{prefix} |{bar}| {percent}% {suffix}", end=print_end)
    if iteration == total:
        log()
