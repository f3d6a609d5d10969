"""The trainers and the distiller on two gloo ranks (sdm_tpu_torch/train/
loop.py and train/distill.py under DDP and FSDP2), on the CPU.

`--device cpu --num-devices 2` spawns two ranks from one command; they
must write the one-device run's log lines, files and parameters, once.
Then two ranks launched through sdm_tpu's explicit SDM_* env contract join
one group in the trainer's multi-host path (each rank reading its own
DatasetShard), and in that group train one-command-mode runs: plain DDP
and grad accumulation (held to their one-device runs), FSDP2 (its gathered
checkpoint held to the DDP run's and loaded by sdm_tpu's loader), and one
distillation step with injected rows and noise (held to one device), and
the FSDP run resumed from its own checkpoint (held to a one-device resume).
"""

import glob
import json
import os
import re
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.io.checkpoint import (  # noqa: E402
    load_optimizer_from_checkpoint as jax_load_optimizer,
    load_params_from_checkpoint as jax_load_params)
from sdm_tpu.models import UNet as JaxUNet  # noqa: E402
from sdm_tpu.train import step as jax_step  # noqa: E402
from sdm_tpu_torch.diffusion.samplers import ddim_step_list  # noqa: E402
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.ops.schedules import make_schedule  # noqa: E402
from sdm_tpu_torch.train import distill, loop  # noqa: E402
from sdm_tpu_torch.train import step as port_step  # noqa: E402
from tests import torch_parallel_workers as workers  # noqa: E402

STEPS = 3
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
IMG = 8


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("par_imgs")
    rng = np.random.default_rng(0)
    for i in range(8):
        cv2.imwrite(str(d / f"im_{i}.png"),
                    rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8))
    return str(d / "im_*.png")


def _config(img_glob, out_dir, **over):
    cfg = dict(dataset_path=img_glob, use_conditional=False, cond_dim=None,
               out_dir=str(out_dir), checkpoint_steps=2, lr_steps=100,
               max_epoch=2, plot_img_count=4, flip_imgs=True,
               model_checkpoint=None, load_diffusion_optim=False,
               config_checkpoint=None, diffusion_lr=1e-4, batch_size=4,
               noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3,
               diffusion_alg="DDIM", skip_step=5, min_noise_step=1,
               max_noise_step=10, max_actual_noise_step=10, in_channel=3,
               out_channel=3, num_layers=1, num_resnet_block=1,
               attn_layers=[0], attn_heads=1, attn_dim_per_head=None,
               time_dim=8, min_channel=32, max_channel=32, img_recon=False,
               compute_dtype="float32")
    cfg.update(over)
    return cfg


def _log(out_dir):
    with open(os.path.join(out_dir, "Diffusion.log")) as f:
        return f.read().splitlines()


def _masked(lines, out_dir):
    """Log lines without timestamps, the output path, the device count
    and the rate."""
    out = []
    for line in lines:
        line = re.sub(r"^\S+ \S+ ", "", line).replace(str(out_dir), "OUT")
        if line.startswith(("Rate:", "Devices (data mesh)")):
            continue
        out.append(line)
    return out


def _losses(lines):
    return [float(m.group(1)) for m in
            (re.search(r"Diffusion: ([0-9.]+)", line) for line in lines)
            if m]


def _files(out_dir):
    return sorted(os.path.relpath(p, out_dir) for p in glob.glob(
        os.path.join(out_dir, "**", "*"), recursive=True)
        if os.path.isfile(p))


def _ckpt(out_dir, steps=STEPS):
    return torch.load(os.path.join(out_dir, "checkpoint",
                                   f"diffusion_{steps}.pt"))


def _close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_cli_two_ranks_match_one_device(images, tmp_path):
    """`--device cpu --num-devices 2` against the one-device run: the same
    log lines (losses within LOSS_RTOL), the same files written once by
    rank 0, and the same parameters."""
    outs = {}
    for name, extra in (("one", []), ("two", ["--num-devices", "2"])):
        out = tmp_path / name
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(_config(images, out)))
        summary = loop.main(loop.BASE_SPEC, ["-c", str(path), "--device",
                                             "cpu", "--steps", str(STEPS)]
                            + extra)
        assert summary["global_steps"] == STEPS
        outs[name] = (out, summary)
    (one, s1), (two, s2) = outs["one"], outs["two"]
    assert "state" not in s2
    np.testing.assert_allclose(s2["last_loss"], s1["last_loss"],
                               rtol=LOSS_RTOL)
    l1, l2 = _log(one), _log(two)
    assert "Devices (data mesh): 2" in "\n".join(l2)
    m1, m2 = _masked(l1, one), _masked(l2, two)
    assert [re.sub(r"Diffusion: [0-9.]+", "", x) for x in m2] == \
        [re.sub(r"Diffusion: [0-9.]+", "", x) for x in m1]
    np.testing.assert_allclose(_losses(m2), _losses(m1), rtol=LOSS_RTOL)
    assert _files(two) == _files(one)
    # Each save once: one rank writes.
    saves = [x for x in l2 if "Saving" in x]
    assert len(saves) == len(set(saves)) == len(
        [x for x in l1 if "Saving" in x])
    _close(_ckpt(two)["model"], _ckpt(one)["model"])


def _free_address():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _distill_inputs():
    cfg = _config("", "", max_noise_step=10)
    torch.manual_seed(7)
    teacher = UNet.from_config(cfg, dtype=None)
    # A student apart from its teacher, so the loss is far from zero.
    torch.manual_seed(8)
    student = UNet.from_config(cfg, dtype=None)
    rng = np.random.default_rng(3)
    step_list = ddim_step_list(1, 10, 2)
    batch = {"image": torch.from_numpy(rng.integers(
        0, 256, (4, IMG, IMG, 3), dtype=np.uint8)),
        "row": torch.tensor([0, 2, 1, len(step_list) - 1]),
        "eps": torch.from_numpy(rng.standard_normal(
            (4, IMG, IMG, 3)).astype(np.float32))}
    return dict(config=cfg, teacher=teacher.state_dict(),
                student=student.state_dict(), batch=batch,
                step_list=step_list, lr=1e-3)


def _one_device_distill(d):
    teacher = UNet.from_config(d["config"], dtype=None)
    teacher.load_state_dict(d["teacher"])
    student = UNet.from_config(d["config"], dtype=None)
    student.load_state_dict(d["student"])
    teacher.requires_grad_(False)
    optimizer, schedule = port_step.make_optimizer(student.parameters(),
                                                   d["lr"], 100)
    state = port_step.create_train_state(student, optimizer, schedule)
    noise = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=10)
    step = distill.make_distill_step(noise, step_list=d["step_list"])
    loss = float(step(state, teacher, d["batch"])["loss"])
    return loss, student.state_dict()


def test_ranks_in_one_group_match_one_device(images, tmp_path):
    import torch.multiprocessing as mp
    runs = {"multihost": _config(images, tmp_path / "multihost"),
            "ddp": _config(images, tmp_path / "ddp"),
            "fsdp": _config(images, tmp_path / "fsdp", fsdp=True,
                            fsdp_min_size=1000, ema_decay=0.9),
            "accum": _config(images, tmp_path / "accum",
                             grad_accum_steps=2)}
    # FSDP resumed from its own checkpoint (a whole state loaded into the
    # sharded model, Adam moments and EMA included): one more step.
    resume = dict(
        model_checkpoint=str(tmp_path / "fsdp" / "checkpoint"
                             / f"diffusion_{STEPS}.pt"),
        config_checkpoint=str(tmp_path / "fsdp" / "checkpoint"
                              / f"config_{STEPS}.pt"),
        load_diffusion_optim=True)
    runs["fsdp_resume"] = dict(runs["fsdp"], out_dir=str(
        tmp_path / "fsdp_resume"), **resume)
    d = _distill_inputs()
    torch.save({"runs": runs, "steps": STEPS, "distill": d},
               tmp_path / "loop_inputs.pt")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mp.start_processes, workers.sdm_env_entry,
                              args=(_free_address(), str(tmp_path)),
                              nprocs=2, join=True, start_method="spawn")
        # The one-device runs, meanwhile.
        ref = {}
        for name in ("ddp", "accum"):
            out = tmp_path / f"{name}_one"
            loop.run_training(loop.BASE_SPEC,
                              dict(runs[name], out_dir=str(out)),
                              device="cpu", max_steps=STEPS)
            ref[name] = _ckpt(out)
        ref_loss, ref_student = _one_device_distill(d)
        spawned.result()
    ranks = [torch.load(tmp_path / f"loop_rank{r}.pt") for r in range(2)]
    out = tmp_path / "fsdp_resume_one"
    loop.run_training(loop.BASE_SPEC, dict(runs["fsdp_resume"], fsdp=False,
                                           out_dir=str(out)),
                      device="cpu", max_steps=STEPS)
    ref["fsdp_resume"] = _ckpt(out, STEPS + 1)

    for name in runs:
        a, b = ranks[0][name], ranks[1][name]
        assert a["world"] == b["world"] == 2
        assert a["steps"] == b["steps"] == STEPS + (name == "fsdp_resume")
        assert np.isfinite(a["loss"]) and a["loss"] == b["loss"], name
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), (name, k)
        assert "Devices (data mesh): 2" in "\n".join(
            _log(runs[name]["out_dir"])), name

    # The multi-host run read its shards: 4 images a rank, 2 steps an
    # epoch.
    mh_log = _log(runs["multihost"]["out_dir"])
    assert any("Steps: 2 / 2" in line for line in mh_log)
    for name in ("ddp", "accum"):
        got = _ckpt(runs[name]["out_dir"])
        _close(got["model"], ref[name]["model"])
        _close({k: v["exp_avg"] for k, v in got["optimizer"]["state"]
                .items()}, {k: v["exp_avg"] for k, v in
                            ref[name]["optimizer"]["state"].items()})
    # The FSDP run's gathered checkpoint: the DDP run's parameters, an EMA,
    # and loadable by sdm_tpu.
    fs = _ckpt(runs["fsdp"]["out_dir"])
    _close(fs["model"], _ckpt(runs["ddp"]["out_dir"])["model"])
    assert set(fs["ema"]) == set(fs["model"])
    resumed = _ckpt(runs["fsdp_resume"]["out_dir"], STEPS + 1)
    for key in ("model", "ema"):
        _close(resumed[key], ref["fsdp_resume"][key])
    assert float(resumed["optimizer"]["state"][0]["step"]) == STEPS + 1
    net = JaxUNet(num_resnet_blocks=1, in_channel=3, out_channel=3,
                  time_dim=8, num_layers=1, attn_layers=(0,), min_channel=32,
                  max_channel=32, use_pallas=False)
    own = net.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                   jnp.array([1]))["params"]
    skipped = []
    params = jax_load_params(fs, own, log=skipped.append)
    assert not skipped
    tx = jax_step.make_optimizer(1e-4, 100)
    opt = jax_load_optimizer(fs, params, tx.init(params))
    assert int(opt[0].count) == STEPS

    for r in ranks:
        np.testing.assert_allclose(r["distill"]["loss"], ref_loss,
                                   rtol=LOSS_RTOL)
        _close(r["distill"]["params"], ref_student)
