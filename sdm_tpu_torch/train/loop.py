"""Training loop for the four trainers: base eps, cold (x0), doodle (eps
conditioned on an image) and SR (port of sdm_tpu/train/loop.py's BASE_SPEC,
COLD_SPEC, DOODLE_SPEC and SR_SPEC paths).

One loop parameterized by a `TrainerSpec`, consuming the reference's
training-config JSON unchanged (same keys, same validation, same error
strings) and writing the reference's files: model + optimizer checkpoints
and config checkpoints (`checkpoint/diffusion_<step>.pt`,
`checkpoint/config_<step>.pt`, loadable by sdm_tpu and by the reference),
preview grids (`plots/diffusion_plot_<step>.jpg`) and the same log lines.

The model trains on one device (CUDA unless the caller passes "cpu"), fp32
parameters with the config's compute dtype ("compute_dtype", default
bfloat16), through the kernels' autograd Functions. Kept from sdm_tpu:
checkpoint cadence including step 0, the NaN guard firing before anything
is saved, the overlapped loss fetch (step k's loss is read after step k+1
is launched), preemption checkpointing on SIGTERM/SIGINT, resume-LR
semantics, "epoch_checkpoint_every" and "seed", and the step's extensions:
"grad_accum_steps" (batches reshaped to (A, N/A, ...)), "cfg_drop_prob",
"min_snr_gamma", "ema_decay" (the EMA is checkpointed under "ema", resumed
from it, and previews sample from it) and "objective": "V" on the eps
trainers (previews sample the v tag natively). Also as in sdm_tpu:

  "remat"             the U-Net checkpoints its blocks (models/unet.py).
  "async_checkpoint"  a checkpoint snapshots the parameters, Adam state and
      EMA on the device, in stream order before the next step's in-place
      Adam update, and one worker thread at a time fetches, saves and
      previews it while training goes on.
  "device_dataset"    the fused loop (`_run_fused_loop`): the decoded
      dataset lives on the device, "steps_per_call" K steps gather their
      rows there, and a chunk's K losses are read with one sync.
  "profile_trace_dir" a torch.profiler trace of the training loop, one
      file per rank (utils/profiling.py::trace).
  "native_checkpoint" each checkpoint also writes the whole train state
      to checkpoint/native_<step>/ (io/native_ckpt.py); a model_checkpoint
      that is such a directory restores the whole state onto this run's
      layout, the step from the state (sdm_tpu loop.py:333-339, 500-520).

Data parallelism (sdm_tpu loop.py:415-500): one process per device, the
U-Net wrapped in DistributedDataParallel whenever the loop runs inside a
process group (at any size, so a one-rank group runs the real reducer).
`num_devices` (--num-devices) N > 1 from one command spawns N ranks (one
per card; gloo processes with --device cpu); None takes sdm_tpu's count,
the most visible cards that divide the micro-batch. Each rank then trains
on its rows of the global batch the one-device loader gives (a shared
seeded order, each rank decoding only its rows) with the one-device
run's draws (train/step.py), so the run equals the one-device run. Under
"multihost" (or the SDM_* env, parallel/multihost.py) each rank reads its
own DatasetShard instead, as sdm_tpu's hosts do. "fsdp" (more than one
rank) shards the parameters, Adam state and EMA with FSDP2
(parallel/fsdp.py; "fsdp_min_size" sets its units). Only rank 0 writes
the log file, the CSV, checkpoints and previews; the logged loss is the
mean over the ranks, and the NaN guard, the preemption flag and the fused
loop's chunk boundaries come from the same all-reduce on every rank, so
no rank leaves while another waits in a collective. The run ends on a
barrier.

Model parallelism (sdm_tpu loop.py:303-316, 416-502): "tp" shards the
wide weights over a "model" group (parallel/tp.py; "tp_min_width",
default 256) and "sp" splits every image activation along H over a
"space" group (parallel/sp.py). The ranks form the [dp, tp, sp] mesh
(parallel/mesh.py::make_model_mesh): dp = ranks / (tp * sp), each data
rank's rows shared by its tp * sp ranks, which draw the same randomness
and train on the one-device run's numbers. A one-command run spawns dp *
tp * sp ranks (--num-devices, default all visible cards, or tp * sp CPU
processes). Under sp > 1 the kernels are off, as sdm_tpu turns its
kernels off. A TP checkpoint gathers the whole state to rank 0 in the
unsharded format, and previews sample on a plain copy from it. "fsdp"
composes with both (sdm_tpu loop.py:484-503): FSDP2 shards over the data
ranks (parallel/fsdp.py), each rank's TP shard under "tp", with the space
ranks as replicas under "sp"; "device_dataset" composes with "tp", each
model group gathering its data rank's rows.

Previews draw their noise from a generator of their own (seeded from
"seed"), so the training draws do not depend on whether or where a
preview runs.

The doodle trainer reads image/doodle pairs from a TinyDB file
(DoodleImgDataset), writes the startup grid of its preview's conditioning
images (`plots/label_plot.jpg`) and, as sdm_tpu does, draws that preview
batch unseeded.
"""

from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import glob
import json
import logging
import os
import pathlib
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from sdm_tpu_torch.data import (ConditionalImgDataset, DataLoader,
                                DoodleImgDataset, ImageDataset)
from sdm_tpu_torch.data.loader import DatasetShard
from sdm_tpu_torch.diffusion.samplers import (cold_sample, ddim_sample,
                                              ddpm_sample)
from sdm_tpu_torch.diffusion.vpred import tag_v
from sdm_tpu_torch.enums import DiffusionAlg, NoiseScheduler, Objective
from sdm_tpu_torch.io.checkpoint import (diffusion_checkpoint_dict,
                                         load_checkpoint,
                                         load_ema_from_checkpoint,
                                         load_optimizer_from_checkpoint,
                                         load_params_from_checkpoint,
                                         save_model, to_cpu)
from sdm_tpu_torch.io.native_ckpt import load_native, save_native
from sdm_tpu_torch.io.plotting import plot_sampled_images
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.resize import area_resize
from sdm_tpu_torch.parallel import fsdp, multihost as mh, tp as tp_mod
from sdm_tpu_torch.parallel._comm import data_parallel
from sdm_tpu_torch.parallel.mesh import (batch_positions, device_count,
                                         fsdp_mesh, make_mesh,
                                         make_model_mesh, shard_rows,
                                         state_mesh)
from sdm_tpu_torch.parallel.sp import (SpaceShard, check_levels,
                                       validate_spatial_divisibility)
from sdm_tpu_torch.ops.schedules import make_schedule
from sdm_tpu_torch.train.step import (create_train_state, make_optimizer,
                                      make_train_step)
from sdm_tpu_torch.utils import setup_logging
from sdm_tpu_torch.utils.profiling import StepTimer, trace


@dataclasses.dataclass(frozen=True)
class TrainerSpec:
    project_name: str
    objective: Objective
    preview: str                 # "base" | "cold" | "doodle" | "sr"
    dataset: str                 # "cond_or_glob" | "doodle"
    uses_diffusion_alg: bool     # reads config "diffusion_alg" (base/doodle)
    has_flip: bool               # reads config "flip_imgs"
    is_sr: bool = False          # reads lr_dim/sr_dim/cond_t


BASE_SPEC = TrainerSpec("Diffusion", Objective.EPS, "base", "cond_or_glob",
                        uses_diffusion_alg=True, has_flip=True)
COLD_SPEC = TrainerSpec("Noise-Cold-Diffusion", Objective.X0, "cold",
                        "cond_or_glob", uses_diffusion_alg=False, has_flip=True)
DOODLE_SPEC = TrainerSpec("Doodle-Diffusion", Objective.EPS, "doodle",
                          "doodle", uses_diffusion_alg=True, has_flip=False)
SR_SPEC = TrainerSpec("SR-Cold-Diffusion", Objective.RESIDUAL_X0, "sr",
                      "cond_or_glob", uses_diffusion_alg=False, has_flip=True,
                      is_sr=True)

def model_parallel_sizes(config_dict: dict):
    """(tp, sp, tp_min_width) with sdm_tpu's checks (loop.py:426-431)."""
    sp = int(config_dict.get("sp", 1))
    tp = int(config_dict.get("tp", 1))
    if sp < 1:
        raise ValueError(f'"sp" must be >= 1, got {sp}')
    if tp < 1:
        raise ValueError(f'"tp" must be >= 1, got {tp}')
    return tp, sp, int(config_dict.get("tp_min_width", 256))


FUSED_ERROR = ('"device_dataset" fused training supports single-process '
               "runs without sp/grad_accum_steps (dp/tp/fsdp compose)")


def check_fused(config_dict: dict) -> None:
    """sdm_tpu's ValueError for "device_dataset" with sp (loop.py:811),
    raised before any rank starts."""
    _, sp, _ = model_parallel_sizes(config_dict)
    if bool(config_dict.get("device_dataset", False)) and sp > 1:
        raise ValueError(FUSED_ERROR)


def parse_args(spec: TrainerSpec, raw_args=None) -> dict:
    parser = argparse.ArgumentParser(
        description=f"Train {spec.project_name} models.")
    parser.add_argument("-c", "--config-path", required=True,
                        type=pathlib.Path,
                        help="File path to load json config file.")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda", help="Device to train on.")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Devices, one process each (default: the most "
                             "visible cards that divide the batch, or all "
                             "of them under \"tp\"/\"sp\"; with --device "
                             "cpu, 1, or tp * sp).")
    parser.add_argument("--steps", type=int, default=None,
                        help="Stop after this many global steps (smoke runs; "
                             "default: run to max_epoch).")
    return vars(parser.parse_args(raw_args))


def checkpoint_dominates_epoch(ckpt_seconds: float,
                               epoch_seconds: float) -> bool:
    """True when the epoch-end checkpoint took more than half the epoch
    (and more than 5 s)."""
    compute_s = max(epoch_seconds - ckpt_seconds, 0.0)
    return ckpt_seconds > 5.0 and ckpt_seconds > 0.5 * max(compute_s, 1e-9)


class CheckpointWorker:
    """Runs one background checkpoint at a time (config
    "async_checkpoint"). `start` first waits for the one in flight;
    `finish` waits and re-raises what the last one raised."""

    def __init__(self):
        self._thread = None
        self._error = None

    def _run(self, fn, args):
        try:
            fn(*args)
        except Exception as e:  # kept for finish(); training goes on
            logging.exception("Background checkpoint failed")
            self._error = e

    def start(self, fn, *args) -> None:
        self.finish()
        self._thread = threading.Thread(target=self._run, args=(fn, args),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def finish(self) -> None:
        self.wait()
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def train_device(device) -> torch.device:
    """`device` as a torch.device; inside a process group, CUDA is this
    rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to train on the CPU")
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_initialized()):
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_axis_size(micro: int, n_total: int, tp: int, sp: int) -> int:
    """dp for n_total ranks under tp x sp, with sdm_tpu's checks
    (loop.py:447-457)."""
    if n_total % (tp * sp):
        raise ValueError(
            f"tp={tp} x sp={sp} must divide the device count {n_total}")
    dp = n_total // (tp * sp)
    if micro % dp:
        raise ValueError(
            f"microbatch {micro} must be divisible by the data-axis size "
            f"{dp} ({n_total} devices / tp={tp} / sp={sp})")
    return dp


def ranks_to_spawn(config_dict: dict, dev: torch.device,
                   num_devices: Optional[int]) -> int:
    """How many ranks a one-command run spawns (1: train here): sdm_tpu's
    count rule over the micro-batch; any count of CPU processes. Under
    "tp"/"sp", num_devices ranks (default: every visible card, or tp * sp
    CPU processes), validated as sdm_tpu validates its mesh. 1 inside a
    process group or under a multi-host launch, which fix the ranks
    themselves."""
    if torch.distributed.is_initialized() or mh.wants_multihost(config_dict):
        return 1
    batch_size = config_dict["batch_size"]
    grad_accum = int(config_dict.get("grad_accum_steps", 1))
    micro = batch_size // grad_accum if grad_accum >= 1 else batch_size
    tp, sp, _ = model_parallel_sizes(config_dict)
    if tp * sp == 1:
        return device_count(dev, micro, num_devices)
    visible = (torch.cuda.device_count() if dev.type == "cuda"
               else num_devices or tp * sp)
    n_total = num_devices or visible
    if n_total > visible:
        raise ValueError(f"{n_total} devices asked for, {visible} visible")
    data_axis_size(micro, n_total, tp, sp)
    return n_total


def _spawned_training(spec, config_dict, device, max_steps,
                      max_epoch_override):
    summary = run_training(spec, config_dict, device=device,
                           max_steps=max_steps,
                           max_epoch_override=max_epoch_override)
    return {k: v for k, v in summary.items() if k != "state"}


def run_training(spec: TrainerSpec, config_dict: dict, *,
                 device="cuda", num_devices: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 max_epoch_override: Optional[int] = None) -> dict:
    """Run training from a reference-format config dict on `device`.
    Returns a summary: global_steps, last_loss, preempted, state,
    steps_per_sec and step_times (per-step wall seconds, the first step
    excluded). A run that spawned its ranks returns rank 0's summary
    without "state"."""
    project_name = spec.project_name
    dev = train_device(device)
    check_fused(config_dict)
    n_spawn = ranks_to_spawn(config_dict, dev, num_devices)
    if n_spawn > 1:
        return mh.spawn(_spawned_training, n_spawn, dev.type, spec,
                        config_dict, dev.type, max_steps, max_epoch_override)
    mh.maybe_initialize(config_dict, dev)
    dev = train_device(dev)

    # Preemption: the first SIGTERM/SIGINT sets a flag; the loop finishes
    # the in-flight step, checkpoints (NaN guard first) and returns with
    # summary["preempted"] = True. A second signal restores the previous
    # handler and interrupts. Handlers install on the main thread only.
    preempt = {"flag": False, "agreed": False, "prev": {}}

    def _on_preempt_signal(signum, frame):
        if preempt["flag"]:
            signal.signal(signum, preempt["prev"].get(signum, signal.SIG_DFL))
            raise KeyboardInterrupt
        preempt["flag"] = True
        logging.info("Preemption signal received - checkpointing after the "
                     "in-flight step, then exiting cleanly.")

    if (bool(config_dict.get("preempt_checkpoint", True))
            and threading.current_thread() is threading.main_thread()):
        for s in (signal.SIGTERM, signal.SIGINT):
            preempt["prev"][s] = signal.signal(s, _on_preempt_signal)

    def _restore_signal_handlers():
        for s, prev in preempt["prev"].items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass

    worker = CheckpointWorker()
    try:
        summary = _train(spec, config_dict, dev, max_steps,
                         max_epoch_override, preempt, project_name, worker)
    finally:
        worker.wait()
        _restore_signal_handlers()
    mh.barrier("train-end")
    return summary


def _train(spec, config_dict, dev, max_steps, max_epoch_override, preempt,
           project_name, worker):
    # ---- Param unpack & validation (sdm_tpu loop.py:159-223) ----
    starting_epoch = 0
    global_steps = 0
    checkpoint_steps = config_dict["checkpoint_steps"]
    lr_steps = config_dict["lr_steps"]
    max_epoch = config_dict["max_epoch"]
    plot_img_count = config_dict["plot_img_count"]
    use_conditional = (config_dict["use_conditional"]
                       if spec.dataset == "cond_or_glob" else False)
    flip_imgs = config_dict["flip_imgs"] if spec.has_flip else False

    dataset_path = config_dict["dataset_path"]
    if dataset_path is None:
        raise ValueError("No dataset_path entered.")
    out_dir = config_dict["out_dir"]
    os.makedirs(out_dir, exist_ok=True)

    diffusion_checkpoint = config_dict["model_checkpoint"]
    config_checkpoint = config_dict["config_checkpoint"]
    diffusion_lr = config_dict["diffusion_lr"]
    batch_size = config_dict["batch_size"]

    beta_1 = beta_T = None
    if config_dict["noise_scheduler"] == "LINEAR":
        noise_scheduling = NoiseScheduler.LINEAR
        beta_1 = config_dict["beta1"]
        beta_T = config_dict["betaT"]
    elif config_dict["noise_scheduler"] == "COSINE":
        noise_scheduling = NoiseScheduler.COSINE
    else:
        raise ValueError("Invalid noise scheduler type.")

    diffusion_alg = None
    if spec.uses_diffusion_alg:
        if config_dict["diffusion_alg"] == "DDIM":
            diffusion_alg = DiffusionAlg.DDIM
        elif config_dict["diffusion_alg"] == "DDPM":
            diffusion_alg = DiffusionAlg.DDPM
        else:
            raise ValueError("Invalid diffusion algorithm type.")

    min_noise_step = config_dict["min_noise_step"]
    max_noise_step = config_dict["max_noise_step"]
    max_actual_noise_step = config_dict["max_actual_noise_step"]
    skip_step = config_dict["skip_step"]
    if (max_actual_noise_step < min_noise_step
            or max_noise_step < min_noise_step
            or skip_step > max_actual_noise_step
            or skip_step < 0
            or min_noise_step < 0):
        raise ValueError("Invalid step values entered!")

    lr_dim = sr_dim = cond_t = None
    if spec.is_sr:
        lr_dim = config_dict["lr_dim"]
        sr_dim = config_dict["sr_dim"]
        cond_t = config_dict["cond_t"]

    if max_epoch_override is not None:
        max_epoch = max_epoch_override

    world, rank = mh.world(), mh.rank()
    is_main = mh.is_main_process()
    multihost = mh.wants_multihost(config_dict) and world > 1
    if is_main:
        setup_logging(out_dir, project_name)
    else:
        logging.getLogger().setLevel(logging.WARNING)
    # Config "seed" (default 0) makes the run deterministic: model init,
    # the per-step flip/t/eps draws, preview noise and the batch order.
    seed = int(config_dict.get("seed", 0))

    # ---- Dataset & loaders: raw uint8 batches, normalized on the device --
    cache = bool(config_dict.get("cache_dataset", False))
    if spec.dataset == "doodle":
        dataset = DoodleImgDataset(dataset_path=dataset_path, seed=seed,
                                   cache_decoded=cache, normalized=False)
    elif use_conditional:
        dataset = ConditionalImgDataset(dataset_path=dataset_path, seed=seed,
                                        cache_decoded=cache, normalized=False)
    else:
        img_list = glob.glob(dataset_path)
        if len(img_list) == 0:
            raise Exception("No dataset found!")
        dataset = ImageDataset(img_paths=img_list, cache_decoded=cache,
                               normalized=False)
    # Gradient accumulation (config "grad_accum_steps"): one Adam step per
    # batch_size batch, activations for batch_size / A rows at a time.
    grad_accum = int(config_dict.get("grad_accum_steps", 1))
    if grad_accum < 1 or batch_size % grad_accum:
        raise ValueError(
            f"batch size {batch_size} must be divisible by "
            f"grad_accum_steps {grad_accum}")
    micro_batch = batch_size // grad_accum
    tp, sp, tp_min_width = model_parallel_sizes(config_dict)
    mesh = None
    if tp * sp > 1:
        if multihost:
            per_host = (torch.cuda.device_count() if dev.type == "cuda" else
                        int(os.environ.get("LOCAL_WORLD_SIZE", world)))
            if per_host % (tp * sp):
                raise ValueError(
                    f"tp*sp = {tp * sp} must divide the per-host device "
                    f"count {per_host} (model/space groups must not span "
                    "hosts)")
        data_axis_size(micro_batch, world, tp, sp)
        mesh = make_model_mesh(dev.type, tp, sp)
        data_rank, data_world = mesh.data, mesh.dp
    elif micro_batch % world:
        raise ValueError(f"microbatch {micro_batch} must be divisible by "
                         f"{world} devices")
    else:
        data_rank, data_world = rank, world
    local_batch, rows = batch_size, None
    if multihost:
        # batch_size is the global batch; each data rank reads its own
        # shard of the dataset and contributes batch_size / dp rows (its
        # model and space ranks read the same shard).
        local_batch = batch_size // data_world
        dataset = DatasetShard(dataset, mh.shard_indices(
            len(dataset), num_processes=data_world, process_id=data_rank))
        if len(dataset) < local_batch:
            raise ValueError(
                f"dataset shard of {len(dataset)} items cannot fill a "
                f"per-host batch of {local_batch}")
    elif data_world > 1:
        rows = batch_positions(batch_size, grad_accum, data_rank, data_world)
    dataloader = DataLoader(dataset, batch_size=local_batch, shuffle=True,
                            num_workers=8, seed=seed,
                            native_decode=bool(config_dict.get(
                                "native_decode", True)), rows=rows)
    # The doodle preview batch is shuffled unseeded, as in sdm_tpu.
    plot_loader = DataLoader(dataset,
                             batch_size=min(plot_img_count, len(dataset)),
                             shuffle=(spec.preview == "doodle"),
                             num_workers=2, drop_last=False)
    plot_batch = next(iter(plot_loader))

    def host_norm(x):
        return None if x is None else (x.astype(np.float32) - 127.5) / 127.5

    plot_imgs = torch.from_numpy(host_norm(plot_batch["image"])).to(dev)
    plot_labels = plot_batch.get("labels")
    plot_cond_imgs = host_norm(plot_batch.get("cond_img"))
    if use_conditional and plot_labels is not None and is_main:
        # labels.txt CSV append, as the reference does.
        with open(os.path.join(out_dir, "labels.txt"), "a") as f:
            wr = csv.writer(f)
            wr.writerows([dataset.get_labels()]
                         + [list(map(float, row)) for row in plot_labels])
    plot_labels = (torch.from_numpy(plot_labels).to(dev)
                   if plot_labels is not None else None)
    if (spec.preview == "doodle" and plot_cond_imgs is not None
            and is_main):
        # The startup grid of the doodle conditioning images.
        plot_sampled_images(plot_cond_imgs, "label_plot", dest_path=out_dir,
                            log=logging.info)
    if plot_cond_imgs is not None:
        plot_cond_imgs = torch.from_numpy(plot_cond_imgs).to(dev)
    if sp > 1:
        validate_spatial_divisibility(plot_imgs.shape, sp)
        check_levels(plot_imgs.shape[1], config_dict["num_layers"], sp)

    # ---- Model ----
    compute_dtype = {"bfloat16": torch.bfloat16, "float32": None,
                     "fp32": None, "bf16": torch.bfloat16}[
                         str(config_dict.get("compute_dtype",
                                             "bfloat16")).lower()]
    use_kernels = config_dict.get("use_pallas", "auto") is not False
    if sp > 1 and use_kernels:
        # The kernels take whole images (parallel/sp.py), as sdm_tpu's
        # Pallas kernels would replicate attention sp times.
        if config_dict.get("use_pallas") is True:
            logging.info('"sp" > 1: overriding use_pallas=True to False - '
                         "the kernels run on whole images; the plain path "
                         "splits attention at 1x work.")
        use_kernels = False
    if use_kernels:
        mh.build_kernels_once(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = UNet.from_config(config_dict, dtype=compute_dtype,
                               use_kernels=use_kernels)
    fsdp_on = bool(config_dict.get("fsdp", False)) and world > 1
    tp_on = tp > 1
    # FSDP2 shards contiguous parameters only, so a sharded run keeps the
    # conv weights in their default layout (the activations stay
    # channels_last). Its (and a TP run's) checkpoint previews sample on a
    # plain copy, from the gathered weights.
    plain_net = (copy.deepcopy(net).to(dev, memory_format=torch.channels_last)
                 if (fsdp_on or tp_on) and is_main else None)
    net = net.to(dev) if fsdp_on else net.to(
        dev, memory_format=torch.channels_last)

    load_diffusion_optim = config_dict["load_diffusion_optim"]
    pending_optimizer = pending_ema = pending_native = None
    if diffusion_checkpoint is not None and os.path.isdir(
            diffusion_checkpoint):
        # A native checkpoint directory: the whole state (parameters, Adam,
        # EMA, step) restores below, onto this run's layout;
        # load_diffusion_optim does not apply.
        pending_native, diffusion_checkpoint = diffusion_checkpoint, None
    if diffusion_checkpoint is not None:
        ok, ckpt = load_checkpoint(diffusion_checkpoint, log=logging.info)
        if not ok:
            raise Exception("An error occured while loading model checkpoint!")
        load_params_from_checkpoint(ckpt, net, log=logging.info)
        if load_diffusion_optim:
            pending_optimizer = ckpt["optimizer"]
        pending_ema = ckpt if "ema" in ckpt else None

    if config_checkpoint is not None:
        ok, cfg_ckpt = load_checkpoint(config_checkpoint, log=logging.info)
        if not ok:
            raise Exception("An error occured while loading config checkpoint!")
        if noise_scheduling == NoiseScheduler.LINEAR:
            beta_1 = cfg_ckpt["beta_1"]
            beta_T = cfg_ckpt["beta_T"]
        starting_epoch = cfg_ckpt["starting_epoch"]
        global_steps = cfg_ckpt["global_steps"]

    # Resume LR (sdm_tpu loop.py:360-377): torch's optimizer.load_state_dict
    # restores the checkpointed lr, so with load_diffusion_optim the run
    # continues at the SAVED lr, halving every lr_steps from there.
    resume_lr = None
    if pending_optimizer is not None:
        pgs = pending_optimizer.get("param_groups") or []
        if pgs and pgs[0].get("lr") is not None:
            resume_lr = float(pgs[0]["lr"])
            logging.info(f"Resuming at checkpointed LR {resume_lr:.9f} "
                         f"(halving every {lr_steps:,} steps).")
    if fsdp_on or tp_on:
        # Every rank starts from rank 0's weights (DDP broadcasts them
        # itself), then cuts its TP shard, then FSDP2 shards that over
        # the data ranks; the optimizer, the EMA and a resumed state then
        # follow the shards.
        mh.replicate([*net.parameters(), *net.buffers()])
    native = bool(config_dict.get("native_checkpoint", False))
    tp_names, shards = {}, None
    if tp_on:
        param_names = [n for n, _ in net.named_parameters()]
        tp_names = tp_mod.shard_model(net, mesh.model_group, tp_min_width)
        if native or pending_native is not None:
            # Where a native checkpoint places the TP shards.
            shards = tp_mod.StateShards(tp_names, state_mesh(mesh))
        if pending_optimizer is not None:
            pending_optimizer = tp_mod.shard_optimizer_entry(
                pending_optimizer, param_names, tp_names, mesh.model, tp)
        if pending_ema is not None:
            pending_ema = {"ema": tp_mod.shard_tree(
                pending_ema["ema"], tp_names, mesh.model, tp)}
    data_mesh = None
    if fsdp_on:
        data_mesh = (fsdp_mesh(mesh) if mesh is not None
                     else make_mesh(dev.type))
        fsdp.shard_model(net, data_mesh, min_size=int(
            config_dict.get("fsdp_min_size", 2 ** 15)), tp_dims=tp_names)
    optimizer, lr_schedule = make_optimizer(
        net.parameters(), diffusion_lr, lr_steps, resume_lr=resume_lr,
        resume_step=global_steps)
    resume_halvings = (max(0, (global_steps - 1) // lr_steps)
                       if resume_lr is not None else 0)
    # EMA (config "ema_decay"): resumed from the checkpoint's "ema" when it
    # has one, else started at the loaded parameters.
    ema_decay = config_dict.get("ema_decay")
    ema_decay = float(ema_decay) if ema_decay is not None else None
    state = create_train_state(net, optimizer, lr_schedule, step=global_steps,
                               ema=ema_decay is not None)
    if ema_decay is not None and pending_ema is not None:
        load_ema_from_checkpoint(pending_ema, state.ema, log=logging.info)
    if pending_optimizer is not None:
        load = fsdp.load_optimizer if fsdp_on else (
            lambda ckpt, _, opt: load_optimizer_from_checkpoint(ckpt, opt))
        state.count = load({"optimizer": pending_optimizer}, net, optimizer)
    if tp_on:
        state.grad_norm = tp_mod.grad_norm_fn(
            net, tp_names, mesh.model_group,
            data_mesh.get_group(data_mesh.ndim - 1) if fsdp_on else None)
    if pending_native is not None:
        # sdm_tpu loop.py:500-520: the whole state; the step comes from it
        # (config_checkpoint still sets the epoch and the betas).
        try:
            global_steps = load_native(pending_native, state, shards=shards)
        except Exception as e:
            raise Exception(
                f"Failed to restore native checkpoint {pending_native!r} "
                f'(the run\'s "ema_decay" on/off setting and model config '
                f"must match the checkpointed run's): {e}") from e
        logging.info(f"Restored native checkpoint {pending_native} "
                     f"(full state, step {global_steps}).")
    if torch.distributed.is_initialized() and not fsdp_on:
        # The real reducer at any group size, over the data x space ranks
        # of this model index (all ranks without tp/sp).
        state.model = data_parallel(
            net, dev, mesh.reduce_group if mesh is not None else None)

    schedule = make_schedule(config_dict["noise_scheduler"],
                             beta_1=beta_1 if beta_1 is not None else 5e-3,
                             beta_T=beta_T if beta_T is not None else 9e-3,
                             max_noise_step=max_noise_step, device=dev)

    # Config "objective": "V" swaps the eps target for the velocity target
    # on the eps trainers; cold and SR keep their parameterizations.
    objective = spec.objective
    obj_cfg = str(config_dict.get("objective", "")).upper()
    if obj_cfg and obj_cfg != objective.name:
        if obj_cfg == "V" and objective == Objective.EPS:
            objective = Objective.V
        else:
            raise ValueError(
                f'config "objective": "{obj_cfg}" is not valid for this '
                f"trainer (supported: {objective.name}, or V on the "
                "eps-family trainers)")

    def optional_float(key):
        value = config_dict.get(key)
        return float(value) if value is not None else None

    step_fn = make_train_step(
        schedule, objective=objective, min_noise_step=min_noise_step,
        max_actual_noise_step=max_actual_noise_step, flip_imgs=flip_imgs,
        cond_t=cond_t, lr_dim=lr_dim, grad_accum_steps=grad_accum,
        cfg_drop_prob=float(config_dict.get("cfg_drop_prob", 0.0)),
        ema_decay=ema_decay, min_snr_gamma=optional_float("min_snr_gamma"),
        grad_clip_norm=optional_float("grad_clip_norm"),
        shard=(data_rank, data_world),
        space=(SpaceShard(mesh.space_group, mesh.space, sp) if sp > 1
               else None))
    generator = torch.Generator(device=dev).manual_seed(seed)
    preview_generator = torch.Generator(device=dev).manual_seed(seed + 1)

    def lr_of(step_count) -> float:
        # The active schedule in plain Python, for the log lines.
        halvings = max(0, (int(step_count) - 1) // lr_steps)
        if resume_lr is not None:
            return resume_lr * 0.5 ** max(halvings - resume_halvings, 0)
        return float(diffusion_lr) * 0.5 ** halvings

    # ---- Hyperparameter banner (sdm_tpu loop.py:583-609) ----
    logging.info("#" * 100)
    logging.info("Train Parameters:")
    logging.info(f"Max Epoch: {max_epoch:,}")
    logging.info(f"Dataset Path: {dataset_path}")
    logging.info(f"Output Path: {out_dir}")
    logging.info(f"Checkpoint Steps: {checkpoint_steps}")
    logging.info(f"Batch size: {batch_size:,}")
    logging.info(f"Diffusion LR: {lr_of(global_steps):.5f}")
    logging.info(f"Using Conditional Info.: {use_conditional}")
    logging.info(f"Image Augmentation (Random Horizontal Flip): {flip_imgs}")
    logging.info(f"Devices (data mesh): {world}"
                 + (f" [tensor parallelism tp={tp}]" if tp > 1 else "")
                 + (f" [spatial partitioning sp={sp}]" if sp > 1 else "")
                 + (" [FSDP state sharding]" if fsdp_on else ""))
    logging.info(f"Compute dtype: {compute_dtype or torch.float32}")
    if spec.is_sr:
        logging.info(f"Low Resolution Dim: {lr_dim:,}")
        logging.info(f"Super Resolution Dim: {sr_dim:,}")
    logging.info("#" * 100)
    if noise_scheduling == NoiseScheduler.LINEAR:
        logging.info(f"Beta_1: {beta_1:,.5f}")
        logging.info(f"Beta_T: {beta_T:,.5f}")
    logging.info(f"Min Noise Step: {min_noise_step:,}")
    logging.info(f"Max Noise Step: {max_noise_step:,}")
    logging.info(f"Max Actual Noise Step: {max_actual_noise_step:,}")
    logging.info("#" * 100)

    def run_preview(module, weights):
        """The preview sampler (sdm_tpu loop.py:614-697) on `module`, or on
        `module` with `weights` ({name: tensor}: the EMA, or a snapshot)
        in place of its own. Base, cold and doodle start from noise, or
        from the plot images q-sampled at max_actual_noise_step when it is
        below max_noise_step. Base (with the plot labels) and doodle (with
        the plot conditioning images, no labels) sample by DDIM or DDPM;
        cold samples by cold_sample with the same noise, and SR by
        cold_sample conditioned on the q-sampled upsampled LR, plus
        lr_plot. Under V the model carries the v tag."""
        n, h, w = plot_imgs.shape[:3]
        noise_plot = torch.randn((n, h, w, config_dict["out_channel"]),
                                 generator=preview_generator, device=dev)
        model_fn = module
        if weights is not None:
            weights = {k: v.to(dev, non_blocking=True)
                       for k, v in weights.items()}

            def model_fn(x, t, labels):
                return torch.func.functional_call(module, weights,
                                                  (x, t, labels))
        if objective == Objective.V:
            model_fn = tag_v(model_fn)
        if spec.preview in ("base", "cold", "doodle"):
            x_t_plot = noise_plot
            if max_actual_noise_step < max_noise_step:
                x_t_plot = schedule.q_sample(
                    plot_imgs, torch.tensor([max_actual_noise_step],
                                            device=dev), noise_plot)
        if spec.preview in ("base", "doodle"):
            cond = plot_cond_imgs if spec.preview == "doodle" else None
            labels = plot_labels if spec.preview == "base" else None
            if diffusion_alg == DiffusionAlg.DDPM:
                return ddpm_sample(model_fn, schedule, x_t_plot,
                                   generator=preview_generator,
                                   min_noise=min_noise_step,
                                   max_noise=max_actual_noise_step,
                                   cond_img=cond, labels=labels)
            return ddim_sample(model_fn, schedule, x_t_plot,
                               min_noise=min_noise_step,
                               max_noise=max_actual_noise_step,
                               ddim_step_size=skip_step, cond_img=cond,
                               labels=labels)
        if spec.preview == "cold":
            return cold_sample(model_fn, schedule, x_t_plot, noise_plot,
                               min_noise=min_noise_step,
                               max_noise=max_actual_noise_step,
                               skip_step_size=skip_step, labels=plot_labels)
        lr_plot = area_resize(area_resize(plot_imgs, lr_dim, lr_dim),
                              sr_dim, sr_dim)
        x_t_lr = schedule.q_sample(lr_plot, torch.tensor([cond_t],
                                                         device=dev),
                                   noise_plot)
        x0 = cold_sample(model_fn, schedule, noise_plot, noise_plot,
                         min_noise=min_noise_step,
                         max_noise=max_actual_noise_step,
                         skip_step_size=skip_step, cond_img=x_t_lr,
                         labels=plot_labels)
        return x0 + lr_plot

    def checkpoint_and_preview(ckpt, steps, with_preview, module, weights):
        config_state = {"starting_epoch": starting_epoch,
                        "global_steps": int(steps)}
        if noise_scheduling == NoiseScheduler.LINEAR:
            config_state["beta_1"] = beta_1
            config_state["beta_T"] = beta_T
        save_model(config_state, "config", out_dir, checkpoint=True,
                   steps=int(steps), log=logging.info)
        save_model(to_cpu(ckpt), "diffusion", out_dir, checkpoint=True,
                   steps=int(steps), log=logging.info)
        if not with_preview:
            return
        try:
            with torch.no_grad():
                imgs = run_preview(module, weights).cpu().numpy()
            plot_sampled_images(imgs, f"diffusion_plot_{int(steps)}",
                                dest_path=out_dir, log=logging.info)
        except Exception as e:  # a preview must never stop training
            logging.info(f"Preview sampling failed: {e}")

    # Async checkpointing (config "async_checkpoint"; sdm_tpu loop.py:
    # 699-754). torch's Adam updates the parameters in place, so the
    # snapshot is a copy on the device, enqueued on the training stream
    # before the next step's update; the worker previews it on a module of
    # its own, since functional_call swaps a module's parameters while the
    # training thread runs it.
    async_ckpt = bool(config_dict.get("async_checkpoint", False))
    preview_net = (copy.deepcopy(net)
                   if async_ckpt and not (fsdp_on or tp_on) else plain_net)

    def submit_checkpoint(steps, with_preview=True):
        if native:
            # Every rank writes its pieces of the live state, before the
            # next step's update (a collective in a group).
            worker.finish()
            save_native(state, out_dir, int(steps), shards=shards)
        if fsdp_on or tp_on:
            # A collective on every rank: the whole state on rank 0's CPU
            # (under both, gathered over the data ranks, then the model
            # ranks).
            worker.finish()
            snap = tp_mod.checkpoint_dict(
                net, optimizer, lr_of(steps), state.ema, tp_names,
                mesh.model_group if tp_on else None)
            if snap is None:
                return
            if async_ckpt:
                worker.start(checkpoint_and_preview, snap, steps,
                             with_preview, preview_net,
                             snap.get("ema", snap["model"]))
            else:
                checkpoint_and_preview(snap, steps, with_preview,
                                       preview_net,
                                       snap.get("ema", snap["model"]))
            return
        if not is_main:
            return
        if not async_ckpt:
            checkpoint_and_preview(
                diffusion_checkpoint_dict(net, optimizer, lr=lr_of(steps),
                                          ema=state.ema),
                steps, with_preview, net, state.ema)
            return
        worker.finish()  # at most one in flight
        snap = diffusion_checkpoint_dict(net, optimizer, lr=lr_of(steps),
                                         ema=state.ema, device=None)
        worker.start(checkpoint_and_preview, snap, steps, with_preview,
                     preview_net, snap.get("ema", snap["model"]))

    def to_device(b):
        # With grad_accum_steps A, each array is pre-split as (A, N/A, ...).
        if sp > 1:
            # sdm_tpu's put_batch_sp checks each array's height.
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    validate_spatial_divisibility(v.shape, sp, name=k)
        return {k: torch.from_numpy(
                    v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + v.shape[1:]) if grad_accum > 1 else v
                ).to(dev, non_blocking=True)
                for k, v in b.items() if isinstance(v, np.ndarray)}

    # The ranks agree (sdm_tpu loop.py:722-733, 824): each step's loss goes
    # out with this rank's preemption flag in one all-reduce, launched
    # right after the step and read where the loss is read, so every rank
    # logs the global mean and stops, checkpoints or raises at one step.
    flags = torch.tensor([0.0, 1.0], device=dev)

    def agree(losses: torch.Tensor) -> torch.Tensor:
        """[*losses, flag], summed over the ranks (no-op at one rank)."""
        if world == 1:
            return losses
        v = torch.cat([losses.to(torch.float32).reshape(-1),
                       flags[int(preempt["flag"]):][:1]])
        torch.distributed.all_reduce(v)
        return v

    def read(v: torch.Tensor) -> np.ndarray:
        """The mean losses of an `agree`d tensor; records the agreed flag."""
        vals = v.to("cpu", torch.float64).numpy().reshape(-1)
        if world == 1:
            return vals
        preempt["agreed"] = preempt["agreed"] or bool(vals[-1] > 0)
        return vals[:-1] / world

    def stopping() -> bool:
        return preempt["flag"] if world == 1 else preempt["agreed"]

    timer = StepTimer()
    # Config "profile_trace_dir" (sdm_tpu loop.py:787-792): a profiler
    # trace of the loop, one file per rank.
    with trace(config_dict.get("profile_trace_dir"), dev.type):
        if bool(config_dict.get("device_dataset", False)):
            if multihost or sp > 1 or grad_accum > 1:
                raise ValueError(FUSED_ERROR)
            summary = _run_fused_loop(
                config_dict=config_dict, dataset=dataset, dev=dev,
                batch_size=batch_size, seed=seed, state=state,
                step_fn=step_fn, generator=generator, timer=timer,
                preempt=preempt, max_steps=max_steps, max_epoch=max_epoch,
                checkpoint_steps=checkpoint_steps,
                starting_epoch=starting_epoch, global_steps=global_steps,
                lr_of=lr_of, submit_checkpoint=submit_checkpoint,
                agree=agree, read=read, stopping=stopping,
                rows=(data_rank, data_world))
        else:
            summary = _run_epochs(
                config_dict=config_dict, dataloader=dataloader,
                to_device=to_device, state=state, step_fn=step_fn,
                generator=generator, timer=timer, max_steps=max_steps,
                max_epoch=max_epoch, checkpoint_steps=checkpoint_steps,
                starting_epoch=starting_epoch, global_steps=global_steps,
                batch_size=batch_size, lr_of=lr_of,
                submit_checkpoint=submit_checkpoint, agree=agree,
                read=read, stopping=stopping)
    worker.finish()
    return summary


def _run_epochs(*, config_dict, dataloader, to_device, state, step_fn,
                generator, timer, max_steps, max_epoch, checkpoint_steps,
                starting_epoch, global_steps, batch_size, lr_of,
                submit_checkpoint, agree, read, stopping):
    """The per-step epoch loop (sdm_tpu loop.py:827-1011)."""
    last_loss = float("nan")
    stop = False
    # Overlapped loss fetch (config "overlapped_loss_fetch", default true):
    # step k's loss is read after step k+1 is launched, as in sdm_tpu. Log
    # lines stay identical, one step later in wall time, and the NaN guard
    # fires one step late (never after a checkpoint). On CUDA the read
    # waits for the whole stream and the next batch's copy from pageable
    # memory waits for the running step, so each step's launches overlap
    # only that step's own execution.
    overlap_loss = bool(config_dict.get("overlapped_loss_fetch", True))
    ckpt_warned = False

    for epoch in range(starting_epoch, max_epoch):
        epoch_t0 = time.monotonic()
        total_diffusion_loss = 0.0
        training_count = 0
        batch_iter = iter(dataloader)
        pending = None  # deferred (metrics, epoch_index, global_steps)

        def fetch_loss(metrics):
            loss = float(read(metrics["loss"])[0])
            timer.tick()
            if np.isnan(loss):
                raise Exception("NaN encountered during training")
            return loss

        def log_step(loss, idx, steps_at):
            nonlocal last_loss, total_diffusion_loss
            last_loss = loss
            total_diffusion_loss += loss
            temp_avg = total_diffusion_loss / (idx + 1)
            logging.info(
                "Cum. Steps: {:,} | Steps: {:,} / {:,} | Diffusion: {:.5f} | LR: {:.9f}".format(
                    steps_at + 1, idx + 1, len(dataloader), temp_avg,
                    lr_of(steps_at)))

        def process_metrics(metrics, idx, steps_at):
            log_step(fetch_loss(metrics), idx, steps_at)

        batch = next(batch_iter, None)
        device_batch = to_device(batch) if batch is not None else None
        index = -1
        while device_batch is not None:
            index += 1
            training_count += 1
            metrics = step_fn(state, device_batch, generator)
            metrics["loss"] = agree(metrics["loss"])
            batch = next(batch_iter, None)
            device_batch = to_device(batch) if batch is not None else None
            if pending is not None:
                process_metrics(*pending)
                pending = None

            if global_steps % checkpoint_steps == 0 and global_steps >= 0:
                # The NaN guard fires BEFORE anything is saved.
                loss = fetch_loss(metrics)
                submit_checkpoint(global_steps)
                sps = timer.steps_per_sec()
                if np.isfinite(sps):
                    logging.info(
                        "Rate: {:.3f} steps/sec | {:.1f} imgs/sec".format(
                            sps, sps * batch_size))
                log_step(loss, index, global_steps)
            elif overlap_loss and device_batch is not None:
                pending = (metrics, index, global_steps)
            else:
                process_metrics(metrics, index, global_steps)
            global_steps += 1
            if stopping():
                if pending is not None:
                    process_metrics(*pending)
                    pending = None
                submit_checkpoint(global_steps, with_preview=False)
                logging.info(
                    "Preempted: checkpointed at step {:,}; exiting.".format(
                        global_steps))
                stop = True
                break
            if max_steps is not None and global_steps >= max_steps:
                stop = True
                break
        if pending is not None:
            process_metrics(*pending)
            pending = None

        # End-of-epoch checkpoint; "epoch_checkpoint_every": N saves every
        # N-th epoch only (default 1 = the reference's every epoch).
        every = int(config_dict.get("epoch_checkpoint_every", 1))
        if ((every <= 1 or (epoch + 1) % every == 0 or stop
             or epoch + 1 == max_epoch) and not stopping()):
            t_ck = time.monotonic()
            submit_checkpoint(global_steps, with_preview=False)
            ck_s = time.monotonic() - t_ck
            epoch_s = time.monotonic() - epoch_t0
            if checkpoint_dominates_epoch(ck_s, epoch_s) and not ckpt_warned:
                ckpt_warned = True
                logging.warning(
                    "Epoch-end checkpoint took {:.0f}s vs {:.0f}s of epoch "
                    "compute — epochs are short for this dataset/batch. Set "
                    '"epoch_checkpoint_every": N and/or "async_checkpoint": '
                    "true to stop checkpoint I/O dominating the run."
                    .format(ck_s, max(epoch_s - ck_s, 0.0)))
        if training_count:
            avg = total_diffusion_loss / training_count
            logging.info("Epoch: {:,} | Diffusion: {:.5f} | LR: {:.9f}".format(
                epoch, avg, lr_of(global_steps)))
        if stop:
            break

    return {"global_steps": global_steps, "last_loss": last_loss,
            "preempted": stopping(), "state": state,
            "steps_per_sec": timer.steps_per_sec(),
            "step_times": timer.intervals()}


def fused_index_blocks(seed: int, n_rows: int, b_sz: int,
                       steps_per_epoch: int, k_steps: int):
    """The fused loop's (k_steps, b_sz) row-index blocks, endlessly:
    epoch-sized permutations (each cut to steps_per_epoch * b_sz rows) from
    one seeded stream, concatenated and cut into blocks, as sdm_tpu's
    `_run_fused_loop` cuts them (loop.py:1088-1103), so a seed gives both
    packages the same batch order."""
    perm_rng = np.random.default_rng((int(seed) + 0x9E3779B9) % 2 ** 63)
    buf = np.empty((0,), np.int64)
    while True:
        while buf.size < k_steps * b_sz:
            perm = perm_rng.permutation(n_rows)[:steps_per_epoch * b_sz]
            buf = np.concatenate([buf, perm])
        yield buf[:k_steps * b_sz].reshape(k_steps, b_sz)
        buf = buf[k_steps * b_sz:]


def load_resident(dataset, dev, native_decode: bool) -> dict:
    """The whole decoded dataset as {field: tensor on `dev`}, one transfer
    per array field ("image", and "cond_img" or "labels" where the samples
    carry them), rows in dataset order."""
    loader = DataLoader(dataset, batch_size=min(512, len(dataset)),
                        shuffle=False, num_workers=8, drop_last=False,
                        native_decode=native_decode)
    parts = {}
    for b in loader:
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                parts.setdefault(k, []).append(v)
    if "image" not in parts:
        raise ValueError('"device_dataset" needs array-valued samples')
    return {k: torch.from_numpy(np.concatenate(v, axis=0)).to(dev)
            for k, v in parts.items()}


def _run_fused_loop(*, config_dict, dataset, dev, batch_size, seed, state,
                    step_fn, generator, timer, preempt, max_steps, max_epoch,
                    checkpoint_steps, starting_epoch, global_steps, lr_of,
                    submit_checkpoint, agree, read, stopping, rows=(0, 1)):
    """The device-resident fused loop (config "device_dataset"; sdm_tpu
    loop.py:1014-1158).

    The decoded uint8 dataset goes to the device once. Each chunk of
    `steps_per_call` K steps (default: an epoch's steps, at most 64) takes
    one host index block (`fused_index_blocks`), gathers each step's rows
    on the device and runs the same train step as the per-step loop; the
    K losses stay on the device and are read once, the chunk's only sync.
    The NaN guard fires per chunk, before any checkpoint. Log lines keep
    the per-step format, a chunk's K lines in a burst; --steps may
    overshoot by up to K-1 steps; step-cadence checkpoints land at the
    first chunk boundary at or after their step. On the card the chunk is
    K steps of launches with no host sync between them, not one graph.
    With several ranks each holds the whole dataset (sdm_tpu replicates
    it too) and each step gathers its data rank's rows of the global block
    (`rows`: (data rank, data ranks); the tp ranks of a model group gather
    the same rows); a chunk's losses and preemption flag go through one
    all-reduce, whose mean over every rank is the mean over the data
    ranks."""
    data = load_resident(dataset, dev,
                         bool(config_dict.get("native_decode", True)))
    n_rows = data["image"].shape[0]
    nbytes = sum(v.numel() * v.element_size() for v in data.values())
    b_sz = min(batch_size, n_rows)
    own = shard_rows(b_sz, *rows)
    steps_per_epoch = max(n_rows // b_sz, 1)
    k_steps = int(config_dict.get("steps_per_call", 0)) or min(
        steps_per_epoch, 64)
    logging.info(
        "Device-resident dataset: {:,} rows ({:.1f} MiB) in device memory; "
        "{} steps fused per call.".format(n_rows, nbytes / 2 ** 20, k_steps))

    blocks = fused_index_blocks(seed, n_rows, b_sz, steps_per_epoch, k_steps)
    epoch = starting_epoch
    epoch_idx = 0      # step index within the current epoch
    epoch_loss = 0.0
    last_loss = float("nan")
    last_ckpt_bucket = global_steps // max(checkpoint_steps, 1)
    every = int(config_dict.get("epoch_checkpoint_every", 1))
    stop = False

    while not stop and epoch < max_epoch:
        idx = torch.from_numpy(next(blocks))
        if dev.type == "cuda":
            # Pinned, so the copy waits for no earlier work on the stream
            # (a checkpoint worker's preview may be running there).
            idx = idx.pin_memory()
        idx = idx.to(dev, non_blocking=True)
        losses = []
        for rows in idx[:, own]:
            batch = {k: v.index_select(0, rows) for k, v in data.items()}
            losses.append(step_fn(state, batch, generator)["loss"])
        losses = read(agree(torch.stack(losses)))
        timer.tick()
        if np.isnan(losses).any():
            raise Exception("NaN encountered during training")
        for lv in losses:
            last_loss = float(lv)
            epoch_loss += last_loss
            epoch_idx += 1
            logging.info(
                "Cum. Steps: {:,} | Steps: {:,} / {:,} | Diffusion: {:.5f} "
                "| LR: {:.9f}".format(
                    global_steps + 1, epoch_idx, steps_per_epoch,
                    epoch_loss / epoch_idx, lr_of(global_steps)))
            global_steps += 1
            if epoch_idx == steps_per_epoch:
                logging.info(
                    "Epoch: {:,} | Diffusion: {:.5f} | LR: {:.9f}".format(
                        epoch, epoch_loss / steps_per_epoch,
                        lr_of(global_steps)))
                epoch += 1
                epoch_idx = 0
                epoch_loss = 0.0
                if every >= 1 and epoch % every == 0:
                    submit_checkpoint(global_steps, with_preview=False)
        bucket = global_steps // max(checkpoint_steps, 1)
        if bucket > last_ckpt_bucket:
            last_ckpt_bucket = bucket
            submit_checkpoint(global_steps)
            iv = timer.intervals()
            if iv:
                logging.info(
                    "Rate: {:.3f} steps/sec | {:.1f} imgs/sec".format(
                        k_steps / iv[-1], k_steps * b_sz / iv[-1]))
        if stopping() or (max_steps is not None
                          and global_steps >= max_steps):
            stop = True

    submit_checkpoint(global_steps, with_preview=not stopping())
    if stopping():
        logging.info("Preempted: checkpointed at step {:,}; exiting.".format(
            global_steps))
    iv = timer.intervals()
    per_step = [s / k_steps for s in iv for _ in range(k_steps)]
    sps = (k_steps * len(iv) / sum(iv)) if iv else float("nan")
    return {"global_steps": global_steps, "last_loss": last_loss,
            "preempted": stopping(), "state": state,
            "steps_per_sec": sps, "step_times": per_step}


def main(spec: TrainerSpec, raw_args=None):
    args = parse_args(spec, raw_args)
    with open(args["config_path"], "r") as f:
        config_dict = json.loads(f.read())
    return run_training(spec, config_dict, device=args["device"],
                        num_devices=args["num_devices"],
                        max_steps=args["steps"])
