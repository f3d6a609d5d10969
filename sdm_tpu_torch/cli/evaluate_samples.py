"""Sample-quality evaluation CLI, FID and KID (port of
sdm_tpu/cli/evaluate_samples.py): scores generated samples against a real
image set.

  python -m sdm_tpu_torch.cli.evaluate_samples --real-path 'data/*.jpg' \\
      --gen-path 'out/*.jpg'
  python -m sdm_tpu_torch.cli.evaluate_samples --real-path 'data/*.jpg' \\
      --gen-config exports/model/config.json -n 256 \\
      --gen-args "--diff_alg ddim --ddim_step_size 20 --dtype bfloat16"

The second form samples in-process from an exported bundle through the
port's generators instead of reading files. Features: eval/features.py
("pixel[:R]", "randconv[:R]", sdm_tpu's fixed-seed random conv net, or
"torch:<path>" for a local pretrained extractor). The real set's Gaussian
statistics can be cached in an .npz (--real-stats), so repeated
evaluations skip the real pass. Images load with the cv2 convention (BGR,
[-1, 1]), the space the models train and sample in. Features and samples
run on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import sys

import numpy as np
import torch

from sdm_tpu_torch.data.datasets import _imread_norm
from sdm_tpu_torch.eval.features import make_feature_extractor
from sdm_tpu_torch.eval.fid import (frechet_distance, gaussian_stats,
                                    kernel_distance)
from sdm_tpu_torch.ops.resize import area_resize

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _resolve_paths(path_or_glob: str, cap: int | None) -> list:
    if os.path.isdir(path_or_glob):
        paths = sorted(
            p for p in glob.glob(os.path.join(path_or_glob, "**", "*"),
                                 recursive=True)
            if p.lower().endswith(IMG_EXTS))
    else:
        paths = sorted(glob.glob(path_or_glob))
    if not paths:
        raise FileNotFoundError(f"no images match {path_or_glob!r}")
    return paths[:cap] if cap else paths


def _resize(images: np.ndarray, size: int) -> np.ndarray:
    return area_resize(torch.from_numpy(np.ascontiguousarray(images)),
                       size, size).numpy()


def _load_images(paths: list, size: int | None) -> np.ndarray:
    """Load BGR [-1,1] NHWC, area-resizing everything to a common size
    (the first image's height unless --image-size is given)."""
    imgs, buckets = [], {}
    for p in paths:
        img = _imread_norm(p)
        buckets.setdefault(img.shape[:2], []).append(img)
    if size is None:
        size = next(iter(buckets))[0]
    for (h, w), group in buckets.items():
        batch = np.stack(group)
        if (h, w) != (size, size):
            batch = _resize(batch, size)
        imgs.append(batch)
    return np.concatenate(imgs) if len(imgs) > 1 else imgs[0]


def _generate_samples(args, log) -> np.ndarray:
    """Sample --num-images from the bundle in --gen-batch chunks (distinct
    seeds per chunk), on --device."""
    from sdm_tpu_torch.cli.generate_images_cold_diffusion import (
        generate_images_cold_diffusion)
    from sdm_tpu_torch.cli.generate_images_diffusion import (
        generate_images_diffusion)
    gen = (generate_images_cold_diffusion if args.gen_kind == "cold"
           else generate_images_diffusion)
    extra = shlex.split(args.gen_args or "")
    if "--device" not in extra:
        extra += ["--device", args.device]
    total, bs = args.num_images, min(args.gen_batch, args.num_images)
    outs, done, chunk_idx = [], 0, 0
    while done < total:
        n = min(bs, total - done)
        call = (["-c", args.gen_config, "-n", str(n),
                 "-s", str(args.seed + chunk_idx)] + extra)
        log(f"sampling chunk {chunk_idx}: {n} images")
        outs.append(np.asarray(gen(call, log=log, save_locally=False)))
        done += n
        chunk_idx += 1
    return np.concatenate(outs)


def _save_grid(imgs: np.ndarray, path: str, log) -> None:
    """Write a 5-col grid .jpg of `imgs` ((N,H,W,C), [-1,1], BGR) to `path`
    with plot_sampled_images' exact quantization (io/plotting.py)."""
    import cv2

    from sdm_tpu_torch.io.plotting import make_grid
    grid = make_grid(np.asarray(imgs)[..., ::-1], nrow=5, padding=2,
                     value_range=(-1, 1))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    cv2.imwrite(path, out[..., ::-1])
    log(f"saved generated grid -> {path}")


def evaluate_samples(raw_args=None, log=print, real_cache=None):
    """Score generated samples against a real set. `real_cache` (an optional
    dict the caller owns) memoizes the real side's features and stats
    across repeated in-process calls against the same real set."""
    parser = argparse.ArgumentParser(
        description="Score generated samples against a real image set "
                    "(FID / KID).")
    parser.add_argument("--real-path", required=False, default=None,
                        help="Real images: a directory or a glob pattern "
                             "(same forms the trainers' dataset_path takes).")
    parser.add_argument("--gen-path", default=None,
                        help="Generated images: directory or glob.")
    parser.add_argument("--gen-config", default=None,
                        help="Exported bundle config.json — sample "
                             "--num-images in-process instead of reading "
                             "--gen-path.")
    parser.add_argument("--gen-kind", choices=("base", "cold"),
                        default="base",
                        help="Which generator drives --gen-config "
                             "(base = DDPM/DDIM bundles, cold = BASE-COLD).")
    parser.add_argument("--gen-args", default="",
                        help="Extra args forwarded verbatim to the "
                             "generator, e.g. \"--diff_alg ddim "
                             "--ddim_step_size 20 --dtype bfloat16\".")
    parser.add_argument("-n", "--num-images", type=int, default=64,
                        help="Images to sample with --gen-config.")
    parser.add_argument("--gen-batch", type=int, default=64,
                        help="Sampling batch per generator call (distinct "
                             "seeds).")
    parser.add_argument("--features", default="randconv",
                        help="Feature spec: pixel[:R], randconv[:R], "
                             "torch:<path> (sdm_tpu_torch/eval/features.py).")
    parser.add_argument("--metrics", default="fid,kid",
                        help="Comma list from {fid, kid}.")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="Feature-extraction batch size.")
    parser.add_argument("--image-size", type=int, default=None,
                        help="Resize everything to this square size before "
                             "features (default: first real image's size, "
                             "or the generated size when using stats cache).")
    parser.add_argument("--max-real", type=int, default=None,
                        help="Cap the number of real images read.")
    parser.add_argument("--real-stats", default=None,
                        help=".npz path caching the real set's Gaussian "
                             "stats: written after computing them, reused "
                             "(real images not re-read) when it exists. "
                             "FID only — KID needs raw features and "
                             "re-reads the real set.")
    parser.add_argument("--kid-block-size", type=int, default=1024)
    parser.add_argument("-s", "--seed", type=int, default=2)
    parser.add_argument("--out", default=None,
                        help="Also write the metrics JSON to this path.")
    parser.add_argument("--save-gen-grid", default=None, metavar="PATH",
                        help="Write a 5x5 grid .jpg of the first 25 "
                             "evaluated (generated) images to PATH — the "
                             "visual artifact next to the numbers, with no "
                             "extra sampling.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device for sampling and features.")
    args = parser.parse_args(raw_args)

    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    bad = set(metrics) - {"fid", "kid"}
    if bad or not metrics:
        parser.error(f"--metrics must be from {{fid,kid}}, got {args.metrics!r}")
    if (args.gen_path is None) == (args.gen_config is None):
        parser.error("exactly one of --gen-path / --gen-config is required")

    extract, feat_name = make_feature_extractor(
        args.features, batch_size=args.batch_size, device=args.device)

    # --- generated side -------------------------------------------------
    if args.gen_config is not None:
        gen_imgs = _generate_samples(args, log)
        if args.image_size and gen_imgs.shape[1] != args.image_size:
            gen_imgs = _resize(gen_imgs, args.image_size)
    else:
        gen_paths = _resolve_paths(args.gen_path, None)
        gen_imgs = _load_images(gen_paths, args.image_size)
    log(f"generated set: {gen_imgs.shape[0]} images "
        f"{gen_imgs.shape[1]}x{gen_imgs.shape[2]}")
    if args.save_gen_grid:
        _save_grid(gen_imgs[:25], args.save_gen_grid, log)
    gen_feat = extract(gen_imgs)

    # --- real side ------------------------------------------------------
    real_feat = None
    cached = (args.real_stats and os.path.exists(args.real_stats)
              and "kid" not in metrics)
    if cached:
        with np.load(args.real_stats) as z:
            if str(z["features"]) != feat_name:
                raise ValueError(
                    f"stats cache {args.real_stats} was built with features "
                    f"{z['features']} but this run uses {feat_name}")
            real_mu, real_sigma = z["mu"], z["sigma"]
            n_real = int(z["n"])
        log(f"real set: cached stats ({n_real} images) from {args.real_stats}")
    else:
        if args.real_path is None:
            parser.error("--real-path required (no usable --real-stats cache)")
        size = args.image_size or gen_imgs.shape[1]
        cache_key = (args.real_path, args.max_real, size, feat_name)
        hit = real_cache.get(cache_key) if real_cache is not None else None
        if hit is not None:
            real_feat, real_mu, real_sigma, n_real = hit
            log(f"real set: in-process cached features ({n_real} images)")
        else:
            real_paths = _resolve_paths(args.real_path, args.max_real)
            real_imgs = _load_images(real_paths, size)
            log(f"real set: {real_imgs.shape[0]} images "
                f"{real_imgs.shape[1]}x{real_imgs.shape[2]}")
            real_feat = extract(real_imgs)
            real_mu, real_sigma = gaussian_stats(real_feat)
            n_real = len(real_feat)
            if real_cache is not None:
                real_cache[cache_key] = (real_feat, real_mu, real_sigma,
                                         n_real)
        if args.real_stats and hit is None:
            np.savez(args.real_stats, mu=real_mu, sigma=real_sigma,
                     n=n_real, features=feat_name)
            log(f"cached real stats -> {args.real_stats}")

    # --- metrics --------------------------------------------------------
    result = {"features": feat_name, "n_real": n_real,
              "n_generated": int(len(gen_feat))}
    if "fid" in metrics:
        gen_mu, gen_sigma = gaussian_stats(gen_feat)
        result["fid"] = frechet_distance(real_mu, real_sigma,
                                         gen_mu, gen_sigma)
    if "kid" in metrics:
        kid_mean, kid_std = kernel_distance(
            real_feat, gen_feat, block_size=args.kid_block_size,
            seed=args.seed)
        result["kid"] = kid_mean
        result["kid_std"] = kid_std
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


def run(raw_args=None):
    return evaluate_samples(raw_args, log=lambda *a, **k: print(
        *a, file=sys.stderr, **k))


if __name__ == "__main__":
    run()
