"""Tensor parallelism, spatial partitioning and the collective-bytes
analysis of the port (sdm_tpu_torch/parallel/tp.py, sp.py, analysis.py)
against sdm_tpu's, on the CPU.

Without a process: the sharded weights against sdm_tpu's
tp_param_shardings, the batch specs, divisibility and sampling-mesh rules
and their messages against sp.py's, the halo geometry of each conv kind
(slabs with their neighbours' rows against the whole conv, forward and
backward), and the trainer's and generators' checks.

One four-rank gloo spawn (rank bodies in tests/torch_parallel_workers.py)
trains one step of each of the dp2 x tp2, dp2 x sp2 and tp2 x sp2 layouts
on an injected batch, held to sdm_tpu's one-device step (the tolerances of
tests/test_tp.py and tests/test_sp.py), measures the work and state each
layout takes per rank and the bytes its collectives move, and runs the
trainer with "tp" and "sp" (and the doodle trainer with "sp"), held to
the one-device runs made here meanwhile, and with "sp" and
"async_checkpoint", held to the synchronous "sp" run. The DDPM and SR generators then
run --sp 2 on one image (a spawn each) against one device.

The same spawn holds "fsdp" composed with dp2 x tp2, dp2 x sp2 and tp2 x
sp2 (one step against sdm_tpu's, and the trainer against one device), the
fused loop at dp2 x tp2, a resume from the composed run's gathered
checkpoint, and native checkpoints across layouts: the one-device run's
resumed onto dp2 x tp2 + fsdp, the composed run's resumed on one device.
"""

import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdm_tpu.cli.generate_images_diffusion import \
    generate_images_diffusion as jax_generate
from sdm_tpu.enums import Objective as JaxObjective
from sdm_tpu.io.torch_interop import torch_state_dict_to_params
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.ops.schedules import LinearSchedule
from sdm_tpu.parallel import sp as jax_sp
from sdm_tpu.parallel.tp import make_2d_mesh, tp_param_shardings
from sdm_tpu.train import (create_train_state as jax_create_state,
                           make_optimizer as jax_make_optimizer,
                           make_train_step as jax_make_train_step)
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.cli.generate_images_cold_diffusion import \
    generate_images_cold_diffusion
from sdm_tpu_torch.cli.generate_images_diffusion import \
    generate_images_diffusion
from sdm_tpu_torch.cli.generate_sr_images_diffusion import \
    generate_sr_images_diffusion
from sdm_tpu_torch.data.tinydb_compat import write_tables
from sdm_tpu_torch.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.models.layers import remat_call
from sdm_tpu_torch.parallel import multihost as mh
from sdm_tpu_torch.parallel import sp, tp
from sdm_tpu_torch.train import loop
from tests import torch_parallel_workers as workers

cv2 = pytest.importorskip("cv2")

# sdm_tpu's TP and SP step tests (tests/test_tp.py:22-57,
# tests/test_sp.py:56-79): the same fp32 math split over ranks.
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# Its trainer tests (tests/test_tp.py:108-143): two Adam steps.
RUN_LOSS_RTOL = 5e-4
RUN_PARAM_TOL = dict(rtol=1e-3, atol=2.5e-4)
# Its generator tests (tests/test_sp.py:200-258).
SAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)
T = 10
IMG = 16
BUNDLE_MODEL = dict(in_channel=3, out_channel=3, num_layers=2,
                    num_resnet_block=1, attn_layers=[1], attn_heads=1,
                    attn_dim_per_head=None, time_dim=16, cond_dim=None,
                    min_channel=32, max_channel=64, img_recon=False)
QUIET = dict(log=lambda *a, **k: None, save_locally=False)


def _jax_cfg(cfg):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in cfg.items()}


def _seeded_unet(cfg, seed=0):
    torch.manual_seed(seed)
    return UNet(**cfg)


# ------------------------------------------------------ rules, no process

@pytest.mark.parametrize("min_width", [256, 32])
def test_sharded_names_match_tp_param_shardings(min_width):
    """The port shards the weights whose sdm_tpu kernels
    tp_param_shardings shards (tests/test_tp.py's U-Net, tp = 2), each on
    the dim that holds the kernel's last axis."""
    net = _seeded_unet(workers.FSDP_UNET)
    params = torch_state_dict_to_params(net.state_dict())
    shardings = tp_param_shardings(params, make_2d_mesh(1, 2),
                                   min_width=min_width)
    marks = jax.tree.map(
        lambda p, s: np.full(np.shape(p), "model" in str(s.spec), np.float32),
        params, shardings)
    want = {k for k, v in params_to_state_dict(marks).items()
            if bool(v.all())}
    got = tp.sharded_names(net, 2, min_width)
    assert set(got) == want and want
    for name, dim in got.items():
        layer = net.get_submodule(name.rsplit(".", 1)[0])
        assert dim == (1 if isinstance(layer, torch.nn.ConvTranspose2d)
                       else 0), name


def test_batch_specs_match_sdm_tpu():
    for ndim in range(0, 6):
        for stack in (False, True):
            if stack and ndim == 0:
                continue
            want = jax_sp.spatial_batch_spec(ndim, leading_stack=stack)
            assert sp.spatial_batch_spec(ndim, leading_stack=stack) == \
                tuple(want), (ndim, stack)


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def test_divisibility_checks_match_sdm_tpu():
    for shape, s, stack in [((2, 16, 16, 3), 4, False), ((2, 16), 4, False),
                            ((2, 4, 16, 16, 3), 4, True),
                            ((2, 18, 16, 3), 4, False),
                            ((3, 2, 10, 8, 3), 4, True),
                            ((1, 16, 16, 3), 3, False)]:
        for name in ("image", "cond_img"):
            assert _raised(sp.validate_spatial_divisibility, shape, s,
                           name=name, leading_stack=stack) == _raised(
                jax_sp.validate_spatial_divisibility, shape, s, name=name,
                leading_stack=stack)
    assert "divisible by sp" in _raised(sp.validate_spatial_divisibility,
                                        (2, 18, 16, 3), 4)


@pytest.mark.parametrize("visible", [1, 4, 8])
def test_sampling_layout_matches_auto_dp_sp_mesh(monkeypatch, visible):
    devices = jax.devices()[:visible]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for batch in (1, 2, 3, 4, 8):
        for n in (None, 1, 2, 3, 4, 6, 8):
            for s in (0, 1, 2, 4, 8):
                try:
                    mesh = jax_sp.auto_dp_sp_mesh(batch, n, s)
                    want = (mesh.shape["data"], mesh.shape["space"])
                except ValueError as e:
                    want = str(e)
                try:
                    got = sp.auto_dp_sp(batch, n, s, visible)
                except ValueError as e:
                    got = str(e)
                assert got == want, (batch, n, s, visible)


@pytest.mark.parametrize("kind", ["conv3x3", "down3x3s2", "convT4s2"])
@pytest.mark.parametrize("sp_n", [2, 4])
def test_halo_geometry_matches_the_whole_conv(kind, sp_n):
    """Each slab with `conv_halo`'s rows of its neighbours (zeros past the
    edges) and its H padding gives its block of the whole conv's output;
    the gradients that flow back through the rows equal the whole conv's
    input gradient."""
    torch.manual_seed(1)
    transposed = kind == "convT4s2"
    k, s = (4, 2) if transposed else (3, 2 if kind == "down3x3s2" else 1)
    w = torch.randn((3, 5, k, k) if transposed else (5, 3, k, k),
                    dtype=torch.float64)
    x = torch.randn(2, 3, 16, 8, dtype=torch.float64, requires_grad=True)

    def conv(v, pad):
        fn = F.conv_transpose2d if transposed else F.conv2d
        return fn(v, w, None, s, pad)
    whole = conv(x, 1)
    above, below, pad_h = sp.conv_halo(k, s, 1, transposed)
    h = 16 // sp_n
    slabs = [x[:, :, i * h:(i + 1) * h] for i in range(sp_n)]
    outs = []
    for i, mid in enumerate(slabs):
        top = (slabs[i - 1][:, :, h - above:] if i > 0 and above
               else x.new_zeros((2, 3, above, 8)))
        bottom = (slabs[i + 1][:, :, :below] if i < sp_n - 1 and below
                  else x.new_zeros((2, 3, below, 8)))
        outs.append(conv(torch.cat([top, mid, bottom], 2), (pad_h, 1)))
    got = torch.cat(outs, 2)
    assert got.shape == whole.shape
    torch.testing.assert_close(got, whole, rtol=1e-12, atol=1e-12)
    g = torch.randn_like(whole)
    torch.testing.assert_close(torch.autograd.grad(got, x, g)[0],
                               torch.autograd.grad(whole, x, g)[0],
                               rtol=1e-12, atol=1e-12)
    assert sp.conv_halo(1, 1, 0) == (0, 0, 0)   # the 1x1 shortcuts


def test_spatial_context_is_per_thread():
    """The SP context holds on the thread that entered it: another thread
    (the checkpoint worker's preview) sees none, and a remat replay run by
    a backward on another thread (autograd's own, on CUDA) enters it
    again."""
    shard = sp.SpaceShard(None, 0, 2)
    seen = {"replays": []}

    def fn(v):
        seen["replays"].append(sp.active())
        return v.square()

    def other():
        seen["other"] = sp.active()

    x = torch.randn(3, requires_grad=True)
    with sp.spatial(shard):
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        seen["own"] = sp.active()
        y = remat_call(fn, x, remat=True)
    thread = threading.Thread(target=lambda: y.sum().backward())
    thread.start()
    thread.join()
    assert seen["own"] is shard and seen["other"] is None
    assert seen["replays"] == [shard, shard]
    assert sp.active() is None
    torch.testing.assert_close(x.grad, 2 * x.detach())


def test_every_level_height_must_divide():
    """sdm_tpu checks the input height only (GSPMD pads deeper levels); the
    port refuses a level whose height does not divide, naming it."""
    sp.check_levels(16, 2, 4)
    with pytest.raises(ValueError, match=re.escape(
            "U-Net level 2 has height 4, which must be divisible by sp=8")):
        sp.check_levels(16, 2, 8)
    with pytest.raises(ValueError, match="level 0 has height 18"):
        sp.check_levels(18, 1, 4)


def _loop_config(img_glob, out_dir, **over):
    """tests/test_tp.py's trainer config (batch 8, seed 7, a two-level
    U-Net of widths 32 and 64) at T = 10 for fast previews."""
    cfg = dict(dataset_path=img_glob, use_conditional=False, cond_dim=None,
               out_dir=str(out_dir), checkpoint_steps=2, lr_steps=100,
               max_epoch=4, plot_img_count=4, flip_imgs=True,
               model_checkpoint=None, load_diffusion_optim=False,
               config_checkpoint=None, diffusion_lr=1e-3, batch_size=8,
               noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3,
               diffusion_alg="DDIM", skip_step=5, min_noise_step=1,
               max_noise_step=T, max_actual_noise_step=T, in_channel=3,
               out_channel=3, num_layers=2, num_resnet_block=1,
               attn_layers=[1], attn_heads=1, attn_dim_per_head=None,
               time_dim=16, min_channel=32, max_channel=64,
               img_recon=False, compute_dtype="float32", seed=7)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("over,num_devices,error,message", [
    ({"tp": 0}, None, ValueError, '"tp" must be >= 1'),
    ({"sp": 0}, None, ValueError, '"sp" must be >= 1'),
    ({"tp": 3, "batch_size": 4}, 8, ValueError,
     "must divide the device count"),
    ({"sp": 3, "batch_size": 4}, 8, ValueError,
     "must divide the device count"),
    ({"sp": 2, "batch_size": 2}, 8, ValueError, "divisible by the data"),
    ({"sp": 2, "device_dataset": True}, None, ValueError,
     '"device_dataset" fused training supports single-process runs '
     "without sp")],
    ids=["tp0", "sp0", "tp3", "sp3", "data_axis", "device_dataset_sp"])
def test_trainer_checks_match_sdm_tpu(tmp_path, over, num_devices, error,
                                      message):
    """sdm_tpu's checks of "tp" and "sp" (tests/test_tp.py:175-185,
    tests/test_sp.py:261-275, 320-331), raised before any rank starts."""
    with pytest.raises(error, match=message):
        loop.run_training(loop.BASE_SPEC,
                          _loop_config("unused/*.png", tmp_path, **over),
                          device="cpu", num_devices=num_devices,
                          max_steps=1)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_bundles")
    out = {}
    for name, model_type, over in (
            ("base", "BASE", {}),
            ("sr", "SR", dict(in_channel=6, img_recon=True, cond_t=3))):
        cfg = dict(BUNDLE_MODEL, **over)
        torch.manual_seed(41)
        path = str(tmp / f"{name}.pt")
        torch.save(diffusion_checkpoint_dict(UNet.from_config(cfg)), path)
        entry = dict(cfg, min_noise_step=1, max_noise_step=T,
                     noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3)
        folder = export_bundle(name, str(tmp), img_c=3, img_h=IMG,
                               img_w=IMG, model_type=model_type,
                               entries=[(entry, path)])
        out[name] = os.path.join(folder, "config.json")
    return out


def _error(fn, args):
    try:
        fn(args, **QUIET)
    except ValueError as e:  # the message is what is compared
        return str(e)
    return None


@pytest.mark.parametrize("flags", [
    ["--num-devices", "3", "--sp", "2"],
    ["-n", "3", "--num-devices", "4", "--sp", "2"],
    ["-n", "2", "--num-devices", "8", "--sp", "2"]],
    ids=["devices", "batch", "batch_dp4"])
def test_generator_checks_match_sdm_tpu(bundles, flags):
    args = ["-c", bundles["base"], "--diff_alg", "ddim", "--ddim_step_size",
            "5", "-T", str(T), "--device", "cpu"] + flags
    got = _error(generate_images_diffusion, args)
    assert got is not None and got == _error(jax_generate, args)


def test_generator_refuses_a_level_height(bundles):
    """At --sp 8 the 16-row bundle's deepest level (4 rows) does not split:
    the port raises before any rank starts (sdm_tpu pads it)."""
    with pytest.raises(ValueError, match="level 2 has height 4"):
        generate_images_cold_diffusion(
            ["-c", bundles["base"], "--cold_step_size", "5", "-T", str(T),
             "--device", "cpu", "--sp", "8"], **QUIET)


# ------------------------------------------------------- the four ranks

def _sdm_tpu_step(cfg, state_dict, batch):
    """sdm_tpu's one-device step on the injected batch: (loss, the
    parameters after it as a port state_dict)."""
    net = JaxUNet(**_jax_cfg(cfg))
    params = jax.tree.map(jnp.asarray, torch_state_dict_to_params(state_dict))
    tx = jax_make_optimizer(workers.LR, workers.LR_STEPS)
    step = jax_make_train_step(
        lambda p, x, tt, l: net.apply({"params": p}, x, tt, l),
        LinearSchedule.create(5e-3, 9e-3, 1000), tx,
        objective=JaxObjective.EPS)
    state, metrics = jax.jit(step)(
        jax_create_state(params, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return float(metrics["loss"]), params_to_state_dict(
        jax.tree.map(np.asarray, state.params))


def _batch(seed, n, hw):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "eps": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            "t": rng.integers(1, 999, n).astype(np.int32)}


def _images(d):
    """Eight 16x16 images and their doodles, with the doodle TinyDB file."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        for kind in ("im", "doodle"):
            cv2.imwrite(str(d / f"{kind}_{i}.png"),
                        rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8))
        rows.append({"filename": str(d / f"im_{i}.png"),
                     "doodle": str(d / f"doodle_{i}.png")})
    write_tables(str(d / "doodle.json"),
                 {"Data": rows, "Labels": [{"labels": ["doodle"]}]})
    return str(d / "im_*.png")


def _ckpt(out_dir, steps):
    return torch.load(os.path.join(out_dir, "checkpoint",
                                   f"diffusion_{steps}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank spawn, with sdm_tpu's steps and the one-device trainer
    runs made here while it runs; then the one-device resume from the TP
    checkpoint it wrote."""
    tmp = tmp_path_factory.mktemp("mp")
    img_glob = _images(tmp)
    tp_sd = _seeded_unet(workers.FSDP_UNET).state_dict()
    sp_sd = _seeded_unet(workers.SP_UNET).state_dict()
    tp_batch, sp_batch = _batch(0, 8, IMG), _batch(1, 4, IMG)
    as_torch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    steps = {name: dict(unet=workers.SP_UNET if name == "dp2_sp2"
                        else workers.FSDP_UNET,
                        params=sp_sd if name == "dp2_sp2" else tp_sd,
                        batch=as_torch(sp_batch if name == "dp2_sp2"
                                       else tp_batch))
             for name in workers.MP_LAYOUTS}
    base = dict(tp_min_width=workers.TP_MIN_WIDTH)
    doodle = dict(dataset_path=str(tmp / "doodle.json"), in_channel=6)
    cfgs = {"one": _loop_config(img_glob, tmp / "one"),
            "doodle_one": _loop_config(img_glob, tmp / "doodle_one",
                                       **doodle)}
    fused = dict(device_dataset=True, steps_per_call=2)
    cfgs["fused_one"] = dict(cfgs["one"], out_dir=str(tmp / "fused_one"),
                             **fused)
    cfgs["fused_tp"] = dict(cfgs["fused_one"], out_dir=str(tmp / "fused_tp"),
                            tp=2, **base)
    for name, over in (("fsdp_dp2_tp2", dict(tp=2)),
                       ("fsdp_dp2_sp2", dict(sp=2)),
                       ("fsdp_tp2_sp2", dict(tp=2, sp=2,
                                             native_checkpoint=True))):
        cfgs[name] = dict(cfgs["one"], out_dir=str(tmp / name), fsdp=True,
                          fsdp_min_size=2 ** 12, **base, **over)
    native_one = str(tmp / "native_one" / "checkpoint" / "native_2")
    cfgs["native_one"] = dict(cfgs["one"], out_dir=str(tmp / "native_one"),
                              native_checkpoint=True)
    cfgs["tp"] = dict(cfgs["one"], out_dir=str(tmp / "tp"), tp=2, **base)
    cfgs["sp"] = dict(cfgs["one"], out_dir=str(tmp / "sp"), sp=2)
    # Two steps an epoch, a step-0 preview of T steps; the async run trains
    # step 1 while its worker thread runs that preview.
    cfgs["sp_sync"] = dict(cfgs["sp"], out_dir=str(tmp / "sp_sync"),
                           batch_size=4, checkpoint_steps=1, skip_step=1)
    cfgs["sp_async"] = dict(cfgs["sp_sync"], out_dir=str(tmp / "sp_async"),
                            async_checkpoint=True)
    cfgs["doodle_sp"] = dict(cfgs["doodle_one"], out_dir=str(
        tmp / "doodle_sp"), sp=2)
    for name in ("doodle_one", "doodle_sp"):
        del cfgs[name]["flip_imgs"], cfgs[name]["use_conditional"]
    resume = dict(model_checkpoint=str(tmp / "tp" / "checkpoint"
                                       / "diffusion_2.pt"),
                  config_checkpoint=str(tmp / "tp" / "checkpoint"
                                        / "config_2.pt"),
                  load_diffusion_optim=True)
    cfgs["tp_resume"] = dict(cfgs["tp"], out_dir=str(tmp / "tp_resume"),
                             **resume)
    cfgs["resume_one"] = dict(cfgs["one"], out_dir=str(tmp / "resume_one"),
                              **resume)
    composed = str(tmp / "fsdp_tp2_sp2" / "checkpoint")
    cfgs["composed_resume"] = dict(
        cfgs["fsdp_tp2_sp2"], out_dir=str(tmp / "composed_resume"),
        native_checkpoint=False, load_diffusion_optim=True,
        model_checkpoint=os.path.join(composed, "diffusion_2.pt"),
        config_checkpoint=os.path.join(composed, "config_2.pt"))
    cfgs["native_fsdp_tp"] = dict(cfgs["fsdp_dp2_tp2"], out_dir=str(
        tmp / "native_fsdp_tp"), model_checkpoint=native_one)
    cfgs["native_resume_one"] = dict(cfgs["one"], out_dir=str(
        tmp / "native_resume_one"), model_checkpoint=native_one)
    cfgs["composed_native_one"] = dict(cfgs["one"], out_dir=str(
        tmp / "composed_native_one"), model_checkpoint=os.path.join(
            composed, "native_2"))
    torch.manual_seed(2)
    sp_work = dict(unet=workers.SP_ATTN_UNET,
                   params=UNet(**workers.SP_ATTN_UNET).state_dict(),
                   batch=as_torch(_batch(2, 4, 32)))
    runs = {name: ("DOODLE_SPEC" if "doodle" in name else "BASE_SPEC",
                   cfgs[name]) for name in ("tp", "tp_resume", "sp",
                                            "sp_sync", "sp_async",
                                            "doodle_sp", "fsdp_dp2_tp2",
                                            "fsdp_dp2_sp2", "fsdp_tp2_sp2",
                                            "fused_tp", "composed_resume",
                                            "native_fsdp_tp")}
    torch.save({"steps": steps, "sp_work": sp_work, "runs": runs,
                "max_steps": {"tp_resume": 3, "composed_resume": 3,
                              "native_fsdp_tp": 3}}, tmp / "mp_inputs.pt")
    # The native checkpoint the spawn resumes, first.
    summaries = {"native_one": loop.run_training(
        loop.BASE_SPEC, cfgs["native_one"], device="cpu", max_steps=2)}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mh.spawn, workers.model_parallel_worker, 4,
                              "cpu", str(tmp))
        ref = {"tp": _sdm_tpu_step(workers.FSDP_UNET, tp_sd, tp_batch),
               "sp": _sdm_tpu_step(workers.SP_UNET, sp_sd, sp_batch)}
        for name in ("one", "doodle_one", "fused_one"):
            spec = loop.DOODLE_SPEC if "doodle" in name else loop.BASE_SPEC
            summaries[name] = loop.run_training(spec, cfgs[name],
                                                device="cpu", max_steps=2)
        summaries["native_resume_one"] = loop.run_training(
            loop.BASE_SPEC, cfgs["native_resume_one"], device="cpu",
            max_steps=3)
        spawned.result()
    for name in ("resume_one", "composed_native_one"):
        summaries[name] = loop.run_training(
            loop.BASE_SPEC, cfgs[name], device="cpu", max_steps=3)
    ranks = [torch.load(tmp / f"mp_rank{r}.pt") for r in range(4)]
    return dict(ranks=ranks, ref=ref, cfgs=cfgs, summaries=summaries,
                tp_sd=tp_sd)


def _close(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("layout", list(workers.MP_LAYOUTS))
def test_layout_steps_match_sdm_tpu(four_ranks, layout):
    loss, params = four_ranks["ref"]["sp" if layout == "dp2_sp2" else "tp"]
    ranks = four_ranks["ranks"]
    _close(ranks[0][layout]["params"], params, PARAM_TOL)
    for r in ranks:
        np.testing.assert_allclose(r[layout]["loss"], loss, rtol=LOSS_RTOL)
        # Every rank ends with the same (gathered) parameters.
        for k, v in ranks[0][layout]["params"].items():
            assert torch.equal(r[layout]["params"][k], v), (layout, k)
    if workers.MP_LAYOUTS[layout][0] > 1:
        want = tp.sharded_names(_seeded_unet(workers.FSDP_UNET), 2,
                                workers.TP_MIN_WIDTH)
        assert four_ranks["ranks"][0][layout]["sharded"] == sorted(want)
        # grad_clip_norm's norm from the shards: the whole gradient's.
        for r in four_ranks["ranks"]:
            np.testing.assert_allclose(*r[layout]["grad_norm"], rtol=1e-5)


def test_tp_divides_state_and_conv_work(four_ranks):
    """dp2 x tp2 (tp_min_width 32): each rank holds at most 0.6 of the
    parameters and Adam moments and does at most 0.6 of the conv work of
    one device on its rows (FlopCounterMode)."""
    for r in four_ranks["ranks"]:
        w = r["tp_work"]
        assert w["state"] <= 0.6 * w["full_state"], w
        assert 0 < w["conv"] <= 0.6 * w["full_conv"], w


def test_sp_divides_work_and_saved_bytes(four_ranks):
    """dp2 x sp2 on tests/test_sp.py's attention-heavy U-Net at 32x32: each
    rank does at most 0.6 of one device's work on its rows and saves at
    most 0.65 of its bytes for the backward (ideal 0.5)."""
    for r in four_ranks["ranks"]:
        w = r["sp_work"]
        assert w["flops"] <= 0.6 * w["full_flops"], w
        assert w["saved"] <= 0.65 * w["full_saved"], w


def test_collective_bytes_dp_vs_tp(four_ranks):
    """tests/test_tp.py:60-105: pure DP moves one all-reduce of the
    parameter bytes and gathers nothing; dp x tp adds activation gathers;
    SP exchanges halos."""
    for r in four_ranks["ranks"]:
        dp, param_bytes = r["dp4_comm"], r["param_bytes"]
        assert 0.98 * param_bytes <= dp["all-reduce"] < 3 * param_bytes, dp
        assert dp["all-gather"] == 0 and dp["collective-permute"] == 0
        assert set(dp) == {"all-reduce", "all-gather", "reduce-scatter",
                           "collective-permute", "all-to-all", "total"}
        tpc = r["dp2_tp2"]["comm"]
        assert tpc["all-gather"] + tpc["reduce-scatter"] > 0, tpc
        assert tpc["total"] > dp["total"] * 0.5
        assert r["dp2_sp2"]["comm"]["collective-permute"] > 0


@pytest.mark.parametrize("run,one", [("tp", "one"), ("sp", "one"),
                                     ("doodle_sp", "doodle_one")])
def test_trainer_runs_match_one_device(four_ranks, run, one):
    """run_training with "tp": 2 (tp_min_width 32) or "sp": 2 on the four
    ranks (dp 2), 2 steps, against the one-device run: its loss and its
    final checkpoint (written once, by rank 0, in the unsharded format)."""
    r0 = four_ranks["ranks"][0][run]
    assert r0["steps"] == 2
    np.testing.assert_allclose(
        r0["loss"], four_ranks["summaries"][one]["last_loss"],
        rtol=RUN_LOSS_RTOL)
    cfgs = four_ranks["cfgs"]
    got, want = _ckpt(cfgs[run]["out_dir"], 2), _ckpt(cfgs[one]["out_dir"], 2)
    _close(got["model"], want["model"], RUN_PARAM_TOL)
    assert sorted(os.listdir(cfgs[run]["out_dir"])) == sorted(
        os.listdir(cfgs[one]["out_dir"]))


def _files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, fs in os.walk(out_dir) for f in fs)


def test_sp_async_checkpoint_matches_sync(four_ranks):
    """"sp": 2 with "async_checkpoint": rank 0's step-0 preview runs on the
    checkpoint worker's thread while the step-1 slabs train on the main
    one; the preview stays whole (the SP context is per thread), so every
    file, checkpoint and preview equals the synchronous run's."""
    cfgs, ranks = four_ranks["cfgs"], four_ranks["ranks"]
    sync, run = cfgs["sp_sync"]["out_dir"], cfgs["sp_async"]["out_dir"]
    assert ranks[0]["sp_async"] == ranks[0]["sp_sync"]
    names = _files(run)
    assert names == _files(sync)
    assert os.path.join("plots", "diffusion_plot_0.jpg") in names, names
    for name in names:
        a, b = os.path.join(run, name), os.path.join(sync, name)
        if name.endswith(".pt"):
            got, want = torch.load(a), torch.load(b)
            for key in ("model", "optimizer"):
                if key in want:
                    _close(_flat(got[key]), _flat(want[key]),
                           dict(rtol=0, atol=0))
        elif not name.endswith(".log"):  # the log holds wall times
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def _flat(tree, prefix=""):
    """{path: tensor} of a nested checkpoint entry."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if torch.is_tensor(v):
            out[f"{prefix}{k}"] = v
        elif isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_tp_checkpoint_resumes_both_ways(four_ranks):
    """The TP run's checkpoint loads strictly into an unsharded U-Net, with
    an Adam entry of every parameter's whole shape; resumed (with its
    moments) by a TP run, one more step equals the one-device resume."""
    cfgs = four_ranks["cfgs"]
    ckpt = _ckpt(cfgs["tp"]["out_dir"], 2)
    net = UNet.from_config(cfgs["one"])
    net.load_state_dict(ckpt["model"], strict=True)
    shapes = [tuple(p.shape) for p in net.parameters()]
    moments = ckpt["optimizer"]["state"]
    assert [tuple(moments[i]["exp_avg"].shape)
            for i in range(len(shapes))] == shapes
    assert four_ranks["ranks"][0]["tp_resume"]["steps"] == 3
    got = _ckpt(cfgs["tp_resume"]["out_dir"], 3)
    want = _ckpt(cfgs["resume_one"]["out_dir"], 3)
    _close(got["model"], want["model"], RUN_PARAM_TOL)
    _close({k: v["exp_avg"] for k, v in got["optimizer"]["state"].items()},
           {k: v["exp_avg"] for k, v in want["optimizer"]["state"].items()},
           RUN_PARAM_TOL)


@pytest.mark.parametrize("layout", list(workers.MP_LAYOUTS))
def test_fsdp_layout_steps_match_sdm_tpu(four_ranks, layout):
    """FSDP2 over the data ranks composed with each layout (each rank's TP
    shard sharded again; the space ranks replicas): one step against
    sdm_tpu's on one device, the parameters gathered over data, then
    model; the gradient norm from FSDP2's shards of the TP shards against
    the whole gradient's."""
    loss, params = four_ranks["ref"]["sp" if layout == "dp2_sp2" else "tp"]
    first = four_ranks["ranks"][0][f"fsdp_step_{layout}"]["params"]
    _close(first, params, PARAM_TOL)
    for r in four_ranks["ranks"]:
        got = r[f"fsdp_step_{layout}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        for k, v in first.items():
            assert torch.equal(got["params"][k], v), (layout, k)
        if "grad_norm" in got:
            np.testing.assert_allclose(got["grad_norm"],
                                       r[layout]["grad_norm"][1], rtol=1e-5)
    assert ("grad_norm" in four_ranks["ranks"][0][f"fsdp_step_{layout}"]) == (
        workers.MP_LAYOUTS[layout][0] > 1)


@pytest.mark.parametrize("run,one", [
    ("fsdp_dp2_tp2", "one"), ("fsdp_dp2_sp2", "one"),
    ("fsdp_tp2_sp2", "one"), ("fused_tp", "fused_one")])
def test_composed_trainer_runs_match_one_device(four_ranks, run, one):
    """run_training with "fsdp" and "tp" and/or "sp" (dp = 4 / (tp * sp)),
    and the fused loop ("device_dataset") at dp2 x tp2, each model group
    gathering its data rank's rows: 2 steps against the one-device run,
    its loss and its final checkpoint (gathered over data, then model, and
    written once by rank 0 in the unsharded format)."""
    r0 = four_ranks["ranks"][0][run]
    assert r0["steps"] == 2
    np.testing.assert_allclose(
        r0["loss"], four_ranks["summaries"][one]["last_loss"],
        rtol=RUN_LOSS_RTOL)
    cfgs = four_ranks["cfgs"]
    got, want = _ckpt(cfgs[run]["out_dir"], 2), _ckpt(cfgs[one]["out_dir"], 2)
    _close(got["model"], want["model"], RUN_PARAM_TOL)
    names = _files(cfgs[run]["out_dir"])
    want_names = _files(cfgs[one]["out_dir"])
    if cfgs[run].get("native_checkpoint"):
        names = [n for n in names if "native_" not in n]
    assert [n for n in names if not n.endswith(".log")] == [
        n for n in want_names if not n.endswith(".log")]


def test_composed_checkpoint_resumes(four_ranks):
    """The tp2 x sp2 + fsdp run's gathered checkpoint loads strictly into
    an unsharded U-Net with an Adam entry of every parameter's whole
    shape; resumed (with its moments) by the same layout, one more step
    equals the one-device resume of the TP run's checkpoint."""
    cfgs = four_ranks["cfgs"]
    ckpt = _ckpt(cfgs["fsdp_tp2_sp2"]["out_dir"], 2)
    net = UNet.from_config(cfgs["one"])
    net.load_state_dict(ckpt["model"], strict=True)
    assert [tuple(ckpt["optimizer"]["state"][i]["exp_avg"].shape)
            for i in range(len(list(net.parameters())))] == [
        tuple(p.shape) for p in net.parameters()]
    assert four_ranks["ranks"][0]["composed_resume"]["steps"] == 3
    got = _ckpt(cfgs["composed_resume"]["out_dir"], 3)
    want = _ckpt(cfgs["resume_one"]["out_dir"], 3)
    _close(got["model"], want["model"], RUN_PARAM_TOL)
    _close({k: v["exp_avg"] for k, v in got["optimizer"]["state"].items()},
           {k: v["exp_avg"] for k, v in want["optimizer"]["state"].items()},
           RUN_PARAM_TOL)


@pytest.mark.parametrize("run", ["native_fsdp_tp", "composed_native_one"])
def test_native_checkpoints_resume_across_layouts(four_ranks, run):
    """A native checkpoint directory restores the whole state (Adam and the
    step from it, no config checkpoint) onto another layout: the
    one-device run's onto dp2 x tp2 + fsdp, and the tp2 x sp2 + fsdp
    run's (TP shards saved as DTensors of their whole tensors) onto one
    device; one more step equals the one-device native resume."""
    cfgs, summaries = four_ranks["cfgs"], four_ranks["summaries"]
    steps = (four_ranks["ranks"][0][run]["steps"] if run in
             four_ranks["ranks"][0] else summaries[run]["global_steps"])
    assert steps == 3
    got = _ckpt(cfgs[run]["out_dir"], 3)
    want = _ckpt(cfgs["native_resume_one"]["out_dir"], 3)
    _close(got["model"], want["model"], RUN_PARAM_TOL)
    _close({k: v["exp_avg"] for k, v in got["optimizer"]["state"].items()},
           {k: v["exp_avg"] for k, v in want["optimizer"]["state"].items()},
           RUN_PARAM_TOL)
    assert float(got["optimizer"]["state"][0]["step"]) == 3.0


@pytest.mark.parametrize("generator", ["ddpm", "sr"])
def test_generators_sp_match_one_device(bundles, generator):
    """--sp 2 on one image (two ranks, the batch not split at all) against
    one device: DDPM, whose per-step noise every rank draws whole, and the
    SR generator at batch 1, the case DP cannot split."""
    common = ["-T", str(T), "-s", "9", "--device", "cpu"]
    if generator == "ddpm":
        fn, kw = generate_images_diffusion, {}
        args = ["-c", bundles["base"], "-n", "1", "--diff_alg", "ddpm"]
    else:
        fn = generate_sr_images_diffusion
        kw = {"lr_img": np.random.default_rng(3).integers(
            0, 256, (IMG // 2, IMG // 2, 3), dtype=np.uint8)}
        args = ["-c", bundles["sr"], "--cold_step_size", "3"]
    one = fn(args + common, **kw, **QUIET)
    two = fn(args + common + ["--sp", "2"], **kw, **QUIET)
    assert two.shape == one.shape == (1, IMG, IMG, 3)
    np.testing.assert_allclose(two, one, **SAMPLE_TOL)
