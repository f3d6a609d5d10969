"""Readings that set a cell's limits, made on the card at the cell's own
size; the benchmark's runs never run this:

    python3 gpubench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --mode control|half_batch

`control`: the plain reference put in the program's place and computed a
precision lower than the configuration states (bfloat16: float8 e4m3,
every operand of every convolution, linear layer and attention product
rounded, with one scale per tensor; gradients too), compared with the
float32 reference as a run compares the program: on a serving cell, the
same number of images of requests drawn as a run draws them, the largest
among them; on a training cell, the three checked steps.
`half_batch` (training cells): the float32 reference with each step's mean
taken over the first half of its rows only, a planted fault.

Prints one JSON line per seed: {"seed", "mode", "checks"}.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gpubench import harness, traffic  # noqa: E402
from gpubench.reference.unet import fp8_round  # noqa: E402


def serve_control(spec: dict, seed: int, device) -> dict:
    from gpubench.drivers import serve_http
    cfg, wl = spec["config"], spec["workload"]
    mix = wl["mix"]
    reqs = []
    for c in range(mix["clients"]):
        for k in range(8):
            r = traffic.request(mix, seed, c, k)
            reqs.append({"client": c, "k": k, "num_images": r["num_images"],
                         "seed": r["seed"]})
    reqs = serve_http.sample(reqs, seed, wl["check_images"])
    params = harness.make_params(cfg, seed, device)
    want = serve_http.reference_images(cfg, wl, seed, params, reqs, device)
    got = serve_http.reference_images(cfg, wl, seed, params, reqs, device,
                                      quant=fp8_round)
    gap = max(serve_http.image_gap(g, w, b)
              for (g, _), (w, b) in zip(got, want))
    return {"image_gap": {"value": gap, "limit": wl["checks"]["image_gap"]}}


def train_reading(spec: dict, seed: int, device, mode: str) -> dict:
    from gpubench.drivers import train_step
    cfg, wl = spec["config"], spec["workload"]
    want = train_step.reference_steps(cfg, wl, seed, device)
    if mode == "control":
        got = train_step.reference_steps(cfg, wl, seed, device,
                                         quant=fp8_round)
    else:
        got = train_step.reference_steps(cfg, wl, seed, device,
                                         keep=wl["batch"] // 2)
    return train_step.compare(wl, *got, *want)[0]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("control", "half_batch"),
                   required=True)
    args = p.parse_args(argv)
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    spec = harness.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if spec["workload"]["driver"] == "serve_http":
            if args.mode != "control":
                raise SystemExit("serving cells read the control only")
            checks = serve_control(spec, seed, device)
        else:
            checks = train_reading(spec, seed, device, args.mode)
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
