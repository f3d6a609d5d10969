"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It builds the port's kernels into the
checkout (only a cell's first run there compiles), runs the cell's driver
(workloads/<cell>.json names it and the configuration), and prints, as the
last line of its standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`,
`setup_phases`, and last `checks`, each compared number beside its limit.
The same numbers are the last lines of its standard error. `setup_s`
counts from the process's start to the window, the kernel build with it
in the one run of a checkout that compiles; `setup_phases` gives that
build's seconds apart, and the clock at the end of each phase of set-up.

Exits 2 without a result where the card is missing or there are fewer
cards than the cell asks for, and 3 where JAX, Flax or the JAX package is
loaded once the window has closed.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gpubench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv) -> int:
    args = parse(argv)
    harness.cache_env()
    spec = harness.cell_spec(args.workload)
    chips = spec["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"gpubench: the cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from sdm_tpu_torch.kernels import _build
    t_build = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t_build
    phases = {"imports": t_build - START, "build": build_s}
    driver = harness.load_module("drivers", spec["workload"]["driver"])
    out = driver.run({"spec": spec, "seed": args.seed,
                      "seconds": args.seconds, "trace": bool(args.trace),
                      "device": torch.device("cuda"),
                      "clock": harness.Clock(START)})
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"gpubench: JAX or the JAX package is loaded: {loaded}")
        return 3

    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            value = harness.load_module("metrics", m["name"]).read(
                out["record"], out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=out["setup_s"])
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = harness.device_info(chips, out["peak_bytes"])
    line = {"correct": harness.judge(out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if args.trace and out["trace"] is not None:
        device.update(busy_s=out["trace"].busy_s,
                      window_s=out["trace"].window_s)
        line["breakdown"] = out["trace"].breakdown()
    # Set-up's parts, beside the metrics (setup_s alone is one): the
    # kernel build's seconds, which only a checkout's first run spends,
    # and the clock at the end of each phase of the cell's driver.
    phases.update(out.get("phases", {}))
    line["setup_phases"] = phases
    line["checks"] = out["checks"]
    log(f"gpubench: set-up phases (s) {phases}; errors "
        f"{out.get('errors', [])}; notes {out.get('notes', {})}")
    log(f"checks: {harness.check_line(out['checks'])}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
