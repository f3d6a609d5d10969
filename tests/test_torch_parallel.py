"""The port's multi-device modules (sdm_tpu_torch/parallel/) against
sdm_tpu's, on the CPU.

`shard_indices` and the data-parallel count rule are held to sdm_tpu's over
a grid (sdm_tpu's process count, index and device list patched in). One
train step of tests/test_fsdp.py's U-Net runs on two gloo ranks under DDP
and under FSDP2, each rank on its rows of the injected batch, against
sdm_tpu's step on a two-device mesh (plain and FSDP-sharded state).
Sampling stays in one process: the engine with two CPU replicas and the
three generators at --num-devices 2 are held to their one-device runs,
and --pipeline 2 to the sequential ensemble (DDIM), to its per-microbatch
noise streams (DDPM), and to sdm_tpu's pipeline_chain and argument
checks. Every kernel launch enters its tensors' device.
"""

import contextlib
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sdm_tpu.cli.generate_images_diffusion import \
    generate_images_diffusion as jax_generate
from sdm_tpu.enums import Objective as JaxObjective
from sdm_tpu.io.torch_interop import torch_state_dict_to_params
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.ops.schedules import LinearSchedule
from sdm_tpu.parallel import mesh as jax_mesh
from sdm_tpu.parallel import multihost as jax_mh
from sdm_tpu.parallel.fsdp import shard_state_fsdp
from sdm_tpu.parallel.pipeline import pipeline_chain as jax_pipeline_chain
from sdm_tpu.train import (create_train_state as jax_create_state,
                           make_optimizer as jax_make_optimizer,
                           make_train_step as jax_make_train_step)
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.cli.generate_images_cold_diffusion import \
    generate_images_cold_diffusion
from sdm_tpu_torch.cli.generate_images_diffusion import (
    generate_images_diffusion, microbatch_generator)
from sdm_tpu_torch.cli.generate_sr_images_diffusion import \
    generate_sr_images_diffusion
from sdm_tpu_torch.diffusion.samplers import ddpm_sample
from sdm_tpu_torch.io.bundles import build_model_from_bundle, \
    load_bundle_config
from sdm_tpu_torch.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.kernels import (_build, adagn, attention,
                                   attention_block, streaming_attention)
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.parallel import multihost as mh
from sdm_tpu_torch.parallel.mesh import data_parallel_size
from sdm_tpu_torch.parallel.pipeline import pipeline_chain
from sdm_tpu_torch.serving import SamplerEngine
from tests import torch_parallel_workers as workers

# tests/test_fsdp.py's tolerances: the same fp32 math split over ranks.
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# Sampling split over replicas or microbatches: the same rows through the
# same model, normwise.
SAMPLE_TOL = 1e-6
T = 10
IMG = 16
MODEL = dict(in_channel=3, out_channel=3, num_layers=2, num_resnet_block=1,
             attn_layers=[1], attn_heads=1, attn_dim_per_head=None,
             time_dim=16, cond_dim=None, min_channel=32, max_channel=64,
             img_recon=False)
QUIET = dict(log=lambda *a, **k: None, save_locally=False)


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------- sizing

@pytest.mark.parametrize("processes", [1, 2, 3, 4])
def test_shard_indices_match_sdm_tpu(monkeypatch, processes):
    for n in (0, 1, 3, 8, 13):
        for rank in range(processes):
            monkeypatch.setattr(jax, "process_count", lambda: processes)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            for drop in (True, False):
                try:
                    want = jax_mh.shard_indices(n, drop_remainder=drop)
                except ValueError as e:
                    with pytest.raises(ValueError, match=re.escape(str(e))):
                        mh.shard_indices(n, drop_remainder=drop,
                                         num_processes=processes,
                                         process_id=rank)
                    continue
                assert mh.shard_indices(
                    n, drop_remainder=drop, num_processes=processes,
                    process_id=rank) == want, (n, processes, rank, drop)


@pytest.mark.parametrize("visible", [1, 2, 3, 8])
def test_data_parallel_count_matches_auto_data_mesh(monkeypatch, visible):
    """sdm_tpu's auto_data_mesh rule on `visible` devices; past the visible
    count the port raises where sdm_tpu's make_mesh runs on fewer."""
    devices = jax.devices()[:visible]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for batch in range(1, 17):
        for n in [None, *range(1, visible + 3)]:
            try:
                want = jax_mesh.auto_data_mesh(batch, n).devices.size
            except ValueError:
                with pytest.raises(ValueError):
                    data_parallel_size(batch, n, visible)
                continue
            if n is not None and n > visible:
                assert want < n
                with pytest.raises(ValueError, match=f"{n} devices asked "
                                   f"for, {visible} visible"):
                    data_parallel_size(batch, n, visible)
            else:
                assert data_parallel_size(batch, n, visible) == want


# ------------------------------------------------------------ train steps

def _fsdp_setup(batch=8):
    """tests/test_fsdp.py's _setup: its U-Net, a seeded float batch with
    injected t and eps. The weights are the port's seeded init, carried to
    sdm_tpu by sdm_tpu's own converter (faster than its eager init)."""
    cfg = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in workers.FSDP_UNET.items()}
    net = JaxUNet(**cfg)
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    eps = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    t = rng.integers(1, 999, batch).astype(np.int32)
    torch.manual_seed(0)
    state_dict = UNet(**workers.FSDP_UNET).state_dict()
    params = jax.tree.map(jnp.asarray,
                          torch_state_dict_to_params(state_dict))
    schedule = LinearSchedule.create(5e-3, 9e-3, 1000)
    tx = jax_make_optimizer(workers.LR, workers.LR_STEPS)
    step_fn = jax_make_train_step(
        lambda p, x, tt, l: net.apply({"params": p}, x, tt, l), schedule, tx,
        objective=JaxObjective.EPS)
    return (state_dict, params, tx, step_fn,
            {"image": imgs, "eps": eps, "t": t})


def _sdm_tpu_steps(params, tx, step_fn, batch):
    """sdm_tpu's step on a two-device mesh, with replicated state and with
    FSDP-sharded state (min_size 2**12, as tests/test_fsdp.py)."""
    mesh = jax_mesh.make_mesh(2)
    state = jax.device_put(jax_create_state(params, tx),
                           NamedSharding(mesh, P()))
    jbatch = jax_mesh.shard_batch({k: jnp.asarray(v)
                                   for k, v in batch.items()}, mesh)
    s_dp, m_dp = jax.jit(step_fn)(state, jbatch, jax.random.PRNGKey(0))
    state_f, shardings = shard_state_fsdp(state, mesh, min_size=2 ** 12)
    step_f = jax.jit(step_fn, out_shardings=(
        shardings, {"loss": NamedSharding(mesh, P())}))
    s_fs, m_fs = step_f(state_f, jbatch, jax.random.PRNGKey(0))
    return s_dp, m_dp, s_fs, m_fs


def test_ddp_and_fsdp_steps_match_sdm_tpu(tmp_path):
    state_dict, params, tx, step_fn, batch = _fsdp_setup()
    torch.save({"params": state_dict,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_path / "step_inputs.pt")
    with ThreadPoolExecutor(1) as pool:
        # The two ranks run while sdm_tpu's steps compile here.
        spawned = pool.submit(mh.spawn, workers.step_worker, 2, "cpu",
                              str(tmp_path))
        s_dp, m_dp, s_fs, m_fs = _sdm_tpu_steps(params, tx, step_fn, batch)
        spawned.result()
    ranks = [torch.load(tmp_path / f"step_rank{r}.pt") for r in range(2)]

    def same_params(got, jax_params):
        want = params_to_state_dict(jax.tree.map(np.asarray, jax_params))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       err_msg=k, **PARAM_TOL)

    for r in ranks:
        np.testing.assert_allclose(r["ddp_loss"], float(m_dp["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["fsdp_loss"], float(m_fs["loss"]),
                                   rtol=LOSS_RTOL)
        same_params(r["ddp_params"], s_dp.params)
        # Params, and both Adam moments, mostly sharded over the two ranks.
        assert r["fsdp_bytes"] <= 0.6 * r["full_bytes"], r["fsdp_bytes"]
    for k, v in ranks[0]["ddp_params"].items():
        assert torch.equal(v, ranks[1]["ddp_params"][k]), k
    # The gathered FSDP checkpoint (rank 0 only) in the unsharded format.
    ckpt = ranks[0]["fsdp_checkpoint"]
    assert ranks[1]["fsdp_checkpoint"] is None
    same_params(ckpt["model"], s_fs.params)
    n_params = len(ckpt["model"])
    assert sorted(ckpt["optimizer"]["state"]) == list(range(n_params))
    assert ckpt["optimizer"]["param_groups"][0]["params"] == list(
        range(n_params))


# ---------------------------------------------------------- device guard

def test_every_launch_enters_its_tensors_device(monkeypatch):
    """Each wrapper's ctypes launch runs inside torch.cuda.device(<the
    tensors' device>), so the C side's cudaFuncSetAttribute and launch act
    on the card that owns the stream. Driven here with meta tensors, a
    stand-in library and a recording torch.cuda.device."""
    current, seen = [], []

    @contextlib.contextmanager
    def device(d):
        current.append(d)
        yield
        current.pop()

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                seen.append((name, current[-1] if current else None))
                return 0
            return launch

    counters = [adagn.fused_adagn, attention.fused_attention,
                attention_block.linear, streaming_attention.streaming_stats,
                streaming_attention.streaming_apply,
                streaming_attention.streaming_dv,
                streaming_attention.streaming_dk,
                streaming_attention.streaming_dq]
    for fn in counters:
        monkeypatch.setattr(fn, "launches", fn.launches)
        if hasattr(fn, "mma_launches"):
            monkeypatch.setattr(fn, "mma_launches", fn.mma_launches)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a, **k: Lib())
    monkeypatch.setattr(_build, "stream_handle", lambda d: 0)

    def meta(*shape):
        return torch.empty(shape, device="meta")

    sa = streaming_attention
    x, m, g = meta(2, 4, 4, 32), meta(2, 32), meta(32)
    q, q3, ml = meta(2, 16, 1, 32), meta(2, 16, 32), meta(2, 1, 16)
    adagn._forward(x, g, g, m, m, 8, 1e-5)
    attention._forward(q, q, q, 0.1, "q")
    attention_block._linear_forward(meta(16, 32), meta(64, 32), meta(64),
                                    None)
    sa.streaming_stats(q3, q3, 0.1)
    sa.streaming_apply(q3, q3, q3, ml, ml, 0.1)
    sa.streaming_dv(q3, q3, q3, ml, ml, 0.1)
    sa.streaming_dk(q3, q3, q3, q3, ml, ml, ml, 0.1)
    sa.streaming_dq(q3, q3, q3, q3, ml, ml, ml, 0.1)
    assert [name for name, _ in seen] == [
        "sdm_adagn_forward", "sdm_attention_forward", "sdm_linear_forward",
        "sdm_streaming_stats", "sdm_streaming_apply", "sdm_streaming_dv",
        "sdm_streaming_dk", "sdm_streaming_dq"]
    assert all(d == torch.device("meta") for _, d in seen), seen


# -------------------------------------------------------------- sampling

def _export(tmp, name, model_type, ranges, **over):
    cfg = dict(MODEL, **over)
    entries = []
    for i, (lo, hi) in enumerate(ranges):
        torch.manual_seed(30 + i)
        net = UNet.from_config(cfg)
        path = str(tmp / f"{name}{i}.pt")
        torch.save(diffusion_checkpoint_dict(net), path)
        entries.append((dict(cfg, min_noise_step=lo, max_noise_step=hi,
                             noise_scheduler="LINEAR", beta1=5e-3,
                             betaT=9e-3), path))
    out = export_bundle(name, str(tmp), img_c=3, img_h=IMG, img_w=IMG,
                        model_type=model_type, entries=entries)
    return os.path.join(out, "config.json")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_bundles")
    return {"one": _export(tmp, "one", "BASE", [(1, T)]),
            "ensemble": _export(tmp, "ens", "BASE", [(6, T), (1, 5)]),
            "cold": _export(tmp, "cold", "BASE-COLD", [(6, T), (1, 5)],
                            img_recon=True),
            "sr": _export(tmp, "sr", "SR", [(1, T)], in_channel=6,
                          img_recon=True, cond_t=3)}


@pytest.mark.parametrize("alg", ["ddim", "ddpm"])
def test_engine_replicas_match_one_device(bundles, alg):
    """Two CPU replicas against one: the same images, request by request,
    in request order (two coalesced requests of 3 and 1 images)."""
    reqs = [dict(num_images=3, seed=4), dict(num_images=1, seed=9)]
    outs = []
    for n in (1, 2):
        engine = SamplerEngine(bundles["ensemble"], diff_alg=alg,
                               step_size=3, max_T=T, max_batch=4,
                               num_devices=n, device="cpu",
                               log=lambda *a, **k: None)
        assert len(engine.devices) == n
        outs.append(engine.generate_batch(reqs))
    for one, two, r in zip(*outs, reqs):
        assert one.shape == two.shape == (r["num_images"], IMG, IMG, 3)
        assert _normwise(two, one) <= SAMPLE_TOL


@pytest.mark.parametrize("generator", ["ddim", "ddpm", "cold", "sr"])
def test_generators_num_devices_match_one_device(bundles, generator):
    common = ["--device", "cpu", "-s", "3", "-T", str(T)]
    if generator in ("ddim", "ddpm"):
        fn, kw = generate_images_diffusion, {}
        args = ["-c", bundles["ensemble"], "-n", "4", "--diff_alg",
                generator, "--ddim_step_size", "3"]
    elif generator == "cold":
        fn, kw = generate_images_cold_diffusion, {}
        args = ["-c", bundles["cold"], "-n", "4", "--cold_step_size", "3"]
    else:
        fn = generate_sr_images_diffusion
        rng = np.random.default_rng(1)
        kw = {"lr_img": rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)}
        args = ["-c", bundles["sr"], "--cold_step_size", "3"]
    one = fn(args + common + ["--num-devices", "1"], **kw, **QUIET)
    two = fn(args + common + ["--num-devices", "2"], **kw, **QUIET)
    assert np.isfinite(two).all() and two.shape == one.shape
    assert _normwise(two, one) <= SAMPLE_TOL


def _pipeline_args(bundles, alg, *extra):
    return ["-c", bundles["ensemble"], "-n", "4", "--diff_alg", alg,
            "--ddim_step_size", "3", "-T", str(T), "-s", "11", "--device",
            "cpu", *extra]


@pytest.mark.parametrize("alg", ["ddim", "dpmpp"])
def test_pipeline_matches_the_sequential_ensemble(bundles, alg):
    seq = generate_images_diffusion(_pipeline_args(bundles, alg), **QUIET)
    pipe = generate_images_diffusion(
        _pipeline_args(bundles, alg, "--pipeline", "2"), **QUIET)
    assert pipe.shape == seq.shape == (4, IMG, IMG, 3)
    assert _normwise(pipe, seq) <= SAMPLE_TOL


def test_pipeline_ddpm_draws_a_stream_per_microbatch(bundles):
    """x_T from the run's generator, as the sequential path draws it; each
    stage then a seed, and microbatch m of that stage its own stream."""
    pipe = generate_images_diffusion(
        _pipeline_args(bundles, "ddpm", "--pipeline", "2"), **QUIET)
    models, folder = load_bundle_config(bundles["ensemble"])
    gen = torch.Generator().manual_seed(11)
    x_t = torch.randn((4, IMG, IMG, 3), generator=gen)
    stages = []
    for md in models["models"]:
        net, schedule = build_model_from_bundle(md, folder, max_T=T,
                                                device="cpu")
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        stages.append((net, schedule, md, seed))
    want = []
    with torch.inference_mode():
        for m in range(2):
            xm = x_t[2 * m:2 * m + 2]
            for net, schedule, md, seed in stages:
                xm = ddpm_sample(net, schedule, xm,
                                 generator=microbatch_generator(seed, m,
                                                                "cpu"),
                                 min_noise=md["min_noise"],
                                 max_noise=md["max_noise"])
            want.append(xm)
    assert _normwise(pipe, torch.cat(want).numpy()) <= SAMPLE_TOL
    # Not the sequential run's draws.
    seq = generate_images_diffusion(_pipeline_args(bundles, "ddpm"), **QUIET)
    assert _normwise(pipe, seq) > 1e-3


def test_pipeline_chain_matches_sdm_tpu():
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    fns = [lambda v, m, k=k: v * (k + 2) + m for k in range(3)]
    want = jax_pipeline_chain(fns, jax.devices()[:3], jnp.asarray(x), 3)
    got = pipeline_chain(fns, [torch.device("cpu")] * 3,
                         torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError) as jerr:
        jax_pipeline_chain(fns, jax.devices()[:3], jnp.asarray(x), 4)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        pipeline_chain(fns, [torch.device("cpu")] * 3, torch.from_numpy(x),
                       4)


def _error(fn, args):
    try:
        fn(args, **QUIET)
    except Exception as e:  # the type and message are what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["init_img", "inpaint", "num_devices", "sp",
                                  "one_model", "uneven"])
def test_pipeline_argument_checks_match_sdm_tpu(bundles, tmp_path, case):
    args = _pipeline_args(bundles, "ddim", "--pipeline", "2")
    flags = {"init_img": ["--init_img_path", str(tmp_path / "x.png"),
                          "--init_noise_step", "5"],
             "inpaint": ["--inpaint_img_path", str(tmp_path / "x.png"),
                         "--inpaint_mask_path", str(tmp_path / "m.png")],
             "num_devices": ["--num-devices", "2"], "sp": ["--sp", "2"],
             "one_model": ["-c", bundles["one"]],
             "uneven": ["-n", "3"]}[case]
    got = _error(generate_images_diffusion, args + flags)
    assert got is not None and got[0] is ValueError
    assert got == _error(jax_generate, args + flags)
