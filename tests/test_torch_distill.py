"""The port's progressive distillation (sdm_tpu_torch/train/distill.py and
cli/distill_diffusion.py) against sdm_tpu's.

One distillation step is held to sdm_tpu's from the same student and
teacher weights (carried across by `params_to_state_dict`), the same
injected pair rows and eps, and the same non-zero Adam moments (a
checkpoint sdm_tpu writes and the port loads, as
tests/test_torch_train_step.py holds the train step), in EPS and V mode,
with and without the gradient clip: the loss and the parameters after the
update, fp32. The CLI runs end to end on six 8x8 images, with and without
the device-resident dataset, and its students load strictly into sdm_tpu.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.diffusion.samplers import ddim_step_list as jax_step_list  # noqa: E402,E501
from sdm_tpu.enums import Objective as JaxObjective  # noqa: E402
from sdm_tpu.io.checkpoint import (  # noqa: E402
    diffusion_checkpoint_dict as jax_checkpoint_dict,
    load_optimizer_from_checkpoint as jax_load_optimizer,
    load_params_from_checkpoint as jax_load_params)
from sdm_tpu.models import UNet as JaxUNet  # noqa: E402
from sdm_tpu.ops.schedules import make_schedule as jax_make_schedule  # noqa: E402,E501
from sdm_tpu.train import distill as jax_distill  # noqa: E402
from sdm_tpu.train import step as jax_step  # noqa: E402
from sdm_tpu_torch.cli import distill_diffusion  # noqa: E402
from sdm_tpu_torch.diffusion.samplers import ddim_step_list  # noqa: E402
from sdm_tpu_torch.enums import Objective  # noqa: E402
from sdm_tpu_torch.io.checkpoint import diffusion_checkpoint_dict  # noqa: E402,E501
from sdm_tpu_torch.io.interop import params_to_state_dict  # noqa: E402
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.ops.schedules import make_schedule  # noqa: E402
from sdm_tpu_torch.train import distill  # noqa: E402
from tests.test_torch_train_step import (BASE_LR, COUNT, LR_STEPS,  # noqa: E402,E501
                                         PARAM_ATOL_LR, _jax_params,
                                         _nonzero_moments, _port_state,
                                         _save_load)

T_MAX, SS, N, HW = 20, 4, 3, 16
# fp32, the same math in another order. The loss weights each sample by
# up to SNR(t) (about 6e2 at t = 4), so its relative tolerance is that of
# the train step's loss; the target x~ divides by a_u - (s_u/s_t) a_t.
LOSS_RTOL = 1e-5
TARGET_RTOL = 1e-4
CFG = dict(num_resnet_blocks=1, in_channel=3, out_channel=3, time_dim=8,
           cond_dim=None, num_layers=2, attn_layers=(1,), num_heads=1,
           dim_per_head=None, groups=32, min_channel=32, max_channel=64,
           image_recon=False)


def test_distill_pairs_match_sdm_tpu():
    for lo, hi, ss in ((1, 20, 4), (1, 1000, 40), (3, 50, 7), (1, 10, 8)):
        steps = ddim_step_list(lo, hi, ss)
        assert steps == jax_step_list(lo, hi, ss)
        got = distill.distill_pairs(steps)
        want = jax_distill.distill_pairs(steps)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert tuple(got[-1]) == (steps[-1],) * 3


def _schedules():
    return (jax_make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                              max_noise_step=T_MAX),
            make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=T_MAX))


def _teacher(seed=1):
    net, params = _jax_params(CFG, seed)
    port = UNet(**CFG)
    port.load_state_dict(params_to_state_dict(params), strict=True)
    return net, params, port.eval()


def test_distill_target_matches_sdm_tpu():
    """x~ for every pair row of the step-4 grid (the endpoint row takes the
    teacher's own x0) from a teacher with sdm_tpu's weights: normwise
    within TARGET_RTOL of sdm_tpu's."""
    net, params, teacher = _teacher()
    sched_j, sched_t = _schedules()
    pairs = distill.distill_pairs(ddim_step_list(1, T_MAX, SS))
    x_t = np.random.default_rng(3).standard_normal(
        (len(pairs), HW, HW, 3)).astype(np.float32)
    t, m, u = (pairs[:, i] for i in range(3))
    want = np.asarray(jax.jit(lambda *a: jax_distill.distill_target(
        lambda x, tt: net.apply({"params": params}, x, tt, None), sched_j,
        *a))(jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(m),
             jnp.asarray(u)))
    got = distill.distill_target(
        lambda x, tt: teacher(x, tt, None), sched_t, torch.from_numpy(x_t),
        *(torch.from_numpy(v.astype(np.int64)) for v in (t, m, u))).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= TARGET_RTOL
    # The endpoint row is the teacher's x0 = (x - s eps)/a at t = 1.
    assert t[-1] == u[-1] == 1
    eps = teacher(torch.from_numpy(x_t[-1:]), torch.tensor([1]),
                  None).detach().numpy()
    abar = float(sched_t.alpha_bar_at(torch.tensor([1])))
    np.testing.assert_allclose(
        got[-1], ((x_t[-1] - (1 - abar) ** 0.5 * eps) / abar ** 0.5)[0],
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("objective,clip", [("EPS", None), ("V", 1e-3)])
def test_distill_step_matches_sdm_tpu(tmp_path, objective, clip):
    """One step from the same student (sdm_tpu's seed-0 weights, non-zero
    Adam moments at count COUNT), teacher (seed 1), uint8 images, rows
    (two intervals and the endpoint) and eps: the loss within LOSS_RTOL
    and each parameter after the update within PARAM_ATOL_LR of the lr.
    The clip of 1e-3 is far under the gradient's norm, so it is active
    (the clip is the trainers' finish_step, whatever the objective)."""
    net, params = _jax_params(CFG)
    _, teacher_params, teacher = _teacher()
    state_j = _nonzero_moments(params, 1)
    lr = float(jax_step.reference_lr_schedule(BASE_LR, LR_STEPS)(COUNT))
    ckpt = _save_load(tmp_path, jax_checkpoint_dict(
        state_j.params, state_j.opt_state, lr=lr))
    state_t = _port_state(CFG, ckpt)
    rng = np.random.default_rng(4)
    batch = {"image": rng.integers(0, 256, (N, HW, HW, 3), dtype=np.uint8),
             "row": np.array([0, 3, 5], np.int32),
             "eps": rng.standard_normal((N, HW, HW, 3)).astype(np.float32)}
    step_list = ddim_step_list(1, T_MAX, SS)
    sched_j, sched_t = _schedules()

    step_j = jax_distill.make_distill_step(
        lambda p, x, t, l: net.apply({"params": p}, x, t, l), sched_j,
        jax_step.make_optimizer(BASE_LR, LR_STEPS), step_list=step_list,
        objective=JaxObjective[objective], grad_clip_norm=clip)
    new_j, metrics_j = jax.jit(step_j)(
        state_j, jax.tree.map(jnp.asarray, teacher_params),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    step_t = distill.make_distill_step(sched_t, step_list=step_list,
                                       objective=Objective[objective],
                                       grad_clip_norm=clip)
    metrics_t = step_t(state_t, teacher,
                       {k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(metrics_t["loss"]),
                               float(metrics_j["loss"]), rtol=LOSS_RTOL)
    new_j = params_to_state_dict(jax.tree.map(np.asarray, new_j.params))
    for name, p in state_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL_LR * lr,
                                   err_msg=name)
    assert state_t.step == 1 and state_t.count == COUNT + 1
    assert all(p.grad is None for p in teacher.parameters())


# ---- run_distillation and the CLI ----

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Six 8x8 images, a training config and a teacher checkpoint (the
    port's seed-0 U-Net, with an "ema" copy) beside them."""
    d = tmp_path_factory.mktemp("distill")
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(str(d / f"im_{i}.png"),
                    rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    cfg = dict(dataset_path=str(d / "im_*.png"), use_conditional=False,
               out_dir=str(d / "out"), batch_size=2, diffusion_lr=1e-4,
               lr_steps=100, noise_scheduler="LINEAR", beta1=5e-3,
               betaT=9e-3, skip_step=2, min_noise_step=1, max_noise_step=10,
               in_channel=3, out_channel=3, num_layers=1, num_resnet_block=1,
               attn_layers=[0], attn_heads=1, attn_dim_per_head=None,
               time_dim=8, cond_dim=None, min_channel=32, max_channel=32,
               img_recon=False, compute_dtype="float32")
    torch.manual_seed(0)
    net = UNet.from_config(cfg)
    teacher = str(d / "teacher.pt")
    torch.save(diffusion_checkpoint_dict(net, ema=dict(
        net.named_parameters())), teacher)
    torch.save(diffusion_checkpoint_dict(net), str(d / "no_ema.pt"))
    return d, cfg, teacher


def _cli(d, cfg, teacher, sub, *flags, **over):
    cfg = dict(cfg, out_dir=str(d / sub), **over)
    os.makedirs(cfg["out_dir"], exist_ok=True)
    path = d / f"{sub}.json"
    path.write_text(json.dumps(cfg))
    return distill_diffusion.run(
        ["-c", str(path), "--teacher-checkpoint", teacher, "--phases", "2",
         "--steps-per-phase", "2", "--device", "cpu", *flags])


def _log(out_dir):
    with open(os.path.join(out_dir, "Distill-Diffusion.log")) as f:
        return [line.split(" ", 2)[2] for line in f.read().splitlines()]


@pytest.mark.parametrize("device_dataset", [False, True])
def test_cli_writes_students_that_sdm_tpu_loads(setup, device_dataset):
    """Two phases of two steps from the teacher (start step size 2):
    students at step sizes 4 and 8, the phase lines, and each student
    loading into sdm_tpu's params and Adam with every key."""
    d, cfg, teacher = setup
    sub = f"dd{int(device_dataset)}"
    res = _cli(d, cfg, teacher, sub, device_dataset=device_dataset)
    assert res["phase_step_sizes"] == [4, 8]
    assert res["global_steps"] == 4
    assert all(np.isfinite(v) for v in res["phase_losses"])
    out = d / sub / "checkpoint"
    assert sorted(os.listdir(out)) == ["distilled_ss4_2.pt",
                                       "distilled_ss8_4.pt"]
    lines = _log(str(d / sub))
    for want in ("Distillation phase 1/2: student step size 4 (4 visited "
                 "steps), teacher step size 2",
                 "Distillation phase 2/2: student step size 8 (3 visited "
                 "steps), teacher step size 4"):
        assert want in lines
    assert sum(line.startswith("Phase ") for line in lines) == 2
    assert (sum("Device-resident dataset: 6 rows" in line for line in lines)
            == int(device_dataset))

    net = JaxUNet.from_config(cfg)
    params = jax.tree.map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.array([1]),
        None)["params"])
    for name in sorted(os.listdir(out)):
        ckpt = torch.load(out / name)
        assert set(ckpt) == {"model", "optimizer"}
        loaded = jax_load_params(ckpt, params, log=pytest.fail)
        tx = jax_step.make_optimizer(1e-4, 100)
        adam = jax_load_optimizer(ckpt, loaded, tx.init(loaded))[0]
        assert int(adam.count) == 2
        assert ckpt["optimizer"]["param_groups"][0]["lr"] == 1e-4


def test_cli_log_lines_match_sdm_tpu(setup):
    """The same config and teacher through sdm_tpu's run_distillation and
    the port's CLI: the same phase and step lines (losses masked) and the
    same student file names."""
    import re

    from sdm_tpu.train.distill import run_distillation
    d, cfg, teacher = setup
    seen = []
    jax_dir = str(d / "jax")
    run_distillation(dict(cfg, out_dir=jax_dir), teacher_checkpoint=teacher,
                     phases=2, steps_per_phase=2, num_devices=1,
                     log=lambda m: seen.append(str(m)))
    _cli(d, cfg, teacher, "cmp")

    def masked(lines, out_dir):
        return [re.sub(r"Distill: [0-9.]+", "Distill: <loss>",
                       line.replace(out_dir, "<out>")) for line in lines]
    port = [line for line in _log(str(d / "cmp"))
            if not line.startswith("native decode is not ported")]
    assert masked(port, str(d / "cmp")) == masked(seen, jax_dir)
    assert sorted(os.listdir(os.path.join(jax_dir, "checkpoint"))) == \
        sorted(os.listdir(d / "cmp" / "checkpoint"))


def test_cli_ema_teacher_and_its_error(setup):
    d, cfg, teacher = setup
    res = _cli(d, cfg, teacher, "ema", "--use-ema-teacher")
    assert res["phase_step_sizes"] == [4, 8]
    with pytest.raises(ValueError, match="checkpoint carries no 'ema' key"):
        _cli(d, cfg, str(d / "no_ema.pt"), "noema", "--use-ema-teacher")


def test_cli_refuses_more_devices_and_defaults_to_cuda(setup):
    """The CLI defaults to CUDA and raises without it. (--num-devices 2 is
    ported: tests/test_torch_parallel_loop.py runs the distiller on two
    ranks.)"""
    d, cfg, teacher = setup
    args = distill_diffusion.parse_args(["-c", "x.json",
                                         "--teacher-checkpoint", "t.pt"])
    assert args["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distill.run_distillation(dict(cfg, out_dir=str(d / "gpu")),
                                     teacher_checkpoint=teacher)
