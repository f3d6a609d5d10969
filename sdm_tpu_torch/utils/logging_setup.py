"""Logging in the reference's format (the port's own copy of
sdm_tpu/utils/logging_setup.py): DEBUG level, '%(asctime)s %(message)s',
to {out_dir}/{project}.log and to stdout at once."""

from __future__ import annotations

import logging
import os


def setup_logging(out_dir: str, project_name: str) -> None:
    log_path = os.path.join(out_dir, f"{project_name}.log")
    # Reset handlers so repeated runs in one process don't stack.
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    logging.basicConfig(
        format="%(asctime)s %(message)s",
        encoding="utf-8",
        handlers=[logging.FileHandler(log_path), logging.StreamHandler()],
        level=logging.DEBUG)
    # Root DEBUG would also surface library chatter; keep it quiet.
    for noisy in ("PIL", "matplotlib", "torch"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
