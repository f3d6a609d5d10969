"""The port's training step (sdm_tpu_torch/train/step.py) against sdm_tpu's.

Both packages take one step from the same parameters, the same uint8
images, the same injected t and eps, and the same non-zero Adam moments and
step count. The moments come from a checkpoint that sdm_tpu writes and the
port loads, so the step also checks the optimizer interop. The loss, the
gradients and the parameters after the update are compared in fp32. The
port's model runs with use_kernels=True, so the kernels' autograd Functions
(their plain versions on the CPU) carry the backward. Checkpoints the port
writes load back into sdm_tpu's state, moments and count included.

Cases are named by objective, "+cond_img" adding the doodle trainer's
conditioning image to the batch. In bf16 compute (fp32 parameters), each
package's gradient is held to its own fp32 gradient, the port's normwise
error at most BF16_GRAD_FACTOR times sdm_tpu's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdm_tpu.enums import Objective as JaxObjective
from sdm_tpu.io.checkpoint import \
    diffusion_checkpoint_dict as jax_checkpoint_dict
from sdm_tpu.io.checkpoint import \
    load_optimizer_from_checkpoint as jax_load_optimizer
from sdm_tpu.io.checkpoint import \
    load_params_from_checkpoint as jax_load_params
from sdm_tpu.io.torch_interop import _flatten, torch_param_order
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.ops.schedules import make_schedule as jax_make_schedule
from sdm_tpu.train import step as jax_step
from sdm_tpu_torch.enums import Objective
from sdm_tpu_torch.io.checkpoint import (diffusion_checkpoint_dict,
                                         load_checkpoint,
                                         load_ema_from_checkpoint,
                                         load_optimizer_from_checkpoint,
                                         load_params_from_checkpoint)
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.schedules import make_schedule
from sdm_tpu_torch.train import step as port_step

N, HW, LR_DIM, COND_T, T_MAX = 2, 16, 8, 5, 20
BASE_LR, LR_STEPS, COUNT = 1e-3, 3, 5
# fp32, the same math in another order: the loss, and each gradient against
# the model's largest gradient element (conv biases ahead of a one-channel
# GroupNorm have a true gradient of zero, so theirs is rounding noise).
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_OF_MAX = 1e-4, 1e-5
# Parameters after the update, in units of the step's lr: Adam moves each
# element by about lr, and the moments (bounded away from zero) keep that
# move a smooth function of the gradient.
PARAM_ATOL_LR = 1e-4
# bf16 compute against fp32, whole gradient, normwise: the port may be at
# most this many times further from its fp32 gradient than sdm_tpu is.
BF16_GRAD_FACTOR = 2.0


def _objective(case):
    return case.split("+")[0]


def _cfg(case):
    sr = _objective(case) == "RESIDUAL_X0"
    six = sr or case.endswith("+cond_img")
    return dict(num_resnet_blocks=1, in_channel=6 if six else 3,
                out_channel=3, time_dim=8, cond_dim=None, num_layers=2,
                attn_layers=(1,), num_heads=1, dim_per_head=None, groups=32,
                min_channel=32, max_channel=64, image_recon=sr)


def _jax_params(cfg, seed=0):
    net = JaxUNet(**cfg)
    x = jnp.zeros((1, HW, HW, cfg["in_channel"]), jnp.float32)
    labels = (None if cfg["cond_dim"] is None
              else jnp.zeros((1, cfg["cond_dim"]), jnp.float32))
    params = net.init(jax.random.PRNGKey(seed), x, jnp.array([1]),
                      labels)["params"]
    return net, jax.tree.map(np.asarray, params)


def _nonzero_moments(params, seed):
    """An Adam state whose moments are non-zero (nu bounded away from zero)
    and whose counts all read COUNT, as a restored checkpoint's are."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape))
                      .astype(np.float32), params)
    nu = jax.tree.map(lambda m: (np.abs(m) + 0.01) ** 2, mu)
    tx = jax_step.make_optimizer(BASE_LR, LR_STEPS)
    state = jax_step.create_train_state(jax.tree.map(jnp.asarray, params),
                                        tx, step=COUNT)
    adam = state.opt_state[0]._replace(count=jnp.asarray(COUNT, jnp.int32),
                                       mu=mu, nu=nu)
    return state.replace(opt_state=(adam,) + tuple(state.opt_state[1:]))


def _batch(seed, case):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (N, HW, HW, 3), dtype=np.uint8),
             "t": np.array([3, 17], np.int32),
             "eps": rng.standard_normal((N, HW, HW, 3)).astype(np.float32)}
    if case.endswith("+cond_img"):
        batch["cond_img"] = rng.integers(0, 256, (N, HW, HW, 3),
                                         dtype=np.uint8)
    return batch


def _jax_step(net, state, batch, objective, grad_clip_norm=None):
    """One jitted sdm_tpu step; returns (loss, grads, new params). The
    optimizer is sdm_tpu's Adam with a slot beside its state that keeps the
    gradient it was handed."""
    tx = jax_step.make_optimizer(BASE_LR, LR_STEPS)

    def update(g, s, p=None):
        updates, inner = tx.update(g, s[0], p)
        return updates, (inner, g)

    capture = optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    schedule = jax_make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                                 max_noise_step=T_MAX)
    step = jax_step.make_train_step(
        lambda p, x, t, l: net.apply({"params": p}, x, t, l), schedule,
        capture, objective=JaxObjective[objective], min_noise_step=1,
        max_actual_noise_step=T_MAX, cond_t=COND_T, lr_dim=LR_DIM,
        grad_clip_norm=grad_clip_norm)
    state = state.replace(opt_state=(
        state.opt_state, jax.tree.map(jnp.zeros_like, state.params)))
    new_state, metrics = jax.jit(step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return (float(metrics["loss"]),
            jax.tree.map(np.asarray, new_state.opt_state[1]),
            jax.tree.map(np.asarray, new_state.params))


def _port_state(cfg, ckpt):
    torch.manual_seed(1)            # overwritten by the checkpoint
    net = UNet(**cfg)
    load_params_from_checkpoint(ckpt, net, log=lambda *a: None)
    opt, schedule = port_step.make_optimizer(net.parameters(), BASE_LR,
                                             LR_STEPS)
    state = port_step.create_train_state(net, opt, schedule)
    state.count = load_optimizer_from_checkpoint(ckpt, opt)
    return state


def _port_step(state, batch, objective, grad_clip_norm=None):
    schedule = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                             max_noise_step=T_MAX)
    step = port_step.make_train_step(
        schedule, objective=Objective[objective], min_noise_step=1,
        max_actual_noise_step=T_MAX, cond_t=COND_T, lr_dim=LR_DIM,
        grad_clip_norm=grad_clip_norm)
    lr = state.schedule(state.count)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {name: p.grad.clone() for name, p in
             state.model.named_parameters()}
    return float(metrics["loss"]), grads, lr


def _save_load(tmp_path, ckpt):
    path = os.path.join(tmp_path, "diffusion_5.pt")
    torch.save(ckpt, path)
    ok, loaded = load_checkpoint(path, log=lambda *a: None)
    assert ok
    return loaded


def _compare_step(tmp_path, objective, grad_clip_norm=None):
    cfg = _cfg(objective)
    net, params = _jax_params(cfg)
    state_j = _nonzero_moments(params, 1)
    lr_ckpt = float(jax_step.reference_lr_schedule(BASE_LR, LR_STEPS)(COUNT))
    ckpt = _save_load(tmp_path, jax_checkpoint_dict(
        state_j.params, state_j.opt_state, lr=lr_ckpt))
    state_t = _port_state(cfg, ckpt)
    assert state_t.count == COUNT
    batch = _batch(2, objective)
    objective = _objective(objective)

    loss_j, grads_j, new_j = _jax_step(net, state_j, batch, objective,
                                       grad_clip_norm)
    loss_t, grads_t, lr = _port_step(state_t, batch, objective,
                                     grad_clip_norm)
    assert lr == pytest.approx(BASE_LR * 0.5 ** ((COUNT - 1) // LR_STEPS))
    np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)

    grads_j = params_to_state_dict(grads_j)
    assert set(grads_j) == set(grads_t)
    scale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_OF_MAX * scale,
                                   err_msg=name)
    new_j = params_to_state_dict(new_j)
    for name, p in state_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL_LR * lr,
                                   err_msg=name)
    assert state_t.step == 1 and state_t.count == COUNT + 1
    return state_t


@pytest.mark.parametrize("objective", ["EPS", "RESIDUAL_X0", "X0",
                                       "EPS+cond_img", "X0+cond_img"])
def test_step_matches_sdm_tpu(tmp_path, objective):
    _compare_step(tmp_path, objective)


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float64).ravel()
                           for _, g in sorted(grads.items())])


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("objective", ["EPS", "RESIDUAL_X0"])
def test_bf16_gradient_is_as_close_to_fp32_as_sdm_tpu(tmp_path, objective):
    """From the same fp32 parameters, moments and batch, each package's
    gradient with bf16 compute against its own with fp32 compute."""
    cfg = _cfg(objective)
    _, params = _jax_params(cfg)
    state_j = _nonzero_moments(params, 1)
    ckpt = _save_load(tmp_path, jax_checkpoint_dict(
        state_j.params, state_j.opt_state, lr=BASE_LR))
    batch = _batch(2, objective)
    errs = {}
    for pkg in ("sdm_tpu", "port"):
        grads = {}
        for dtype in ("float32", "bfloat16"):
            if pkg == "sdm_tpu":
                net = JaxUNet(**cfg, dtype=(jnp.bfloat16 if dtype ==
                                            "bfloat16" else None))
                g = params_to_state_dict(
                    _jax_step(net, state_j, batch, objective)[1])
                grads[dtype] = _flat({k: v.numpy() for k, v in g.items()})
            else:
                state_t = _port_state(dict(cfg, dtype=(
                    torch.bfloat16 if dtype == "bfloat16" else None)), ckpt)
                g = _port_step(state_t, batch, objective)[1]
                grads[dtype] = _flat({k: v.numpy() for k, v in g.items()})
        errs[pkg] = _normwise(grads["bfloat16"], grads["float32"])
    assert 0 < errs["port"] <= BF16_GRAD_FACTOR * errs["sdm_tpu"], errs


def test_step_with_grad_clip_matches_sdm_tpu(tmp_path):
    """A clip norm far under the gradient's norm, so the clip is active."""
    _compare_step(tmp_path, "EPS", grad_clip_norm=1e-3)


def test_port_checkpoint_loads_into_sdm_tpu(tmp_path):
    """After a port step, the port's checkpoint loads into sdm_tpu's params
    and Adam state with every key, the moments and the count."""
    state_t = _compare_step(tmp_path, "RESIDUAL_X0")
    lr = state_t.schedule(state_t.count)
    ckpt = _save_load(tmp_path, diffusion_checkpoint_dict(
        state_t.model, state_t.optimizer, lr=lr))
    assert ckpt["optimizer"]["param_groups"][0]["lr"] == lr
    assert ckpt["optimizer"]["param_groups"][0]["betas"] == (0.5, 0.999)
    _, params = _jax_params(_cfg("RESIDUAL_X0"), seed=3)
    skipped = []
    loaded = jax_load_params(ckpt, params, log=skipped.append)
    assert skipped == []
    sd = params_to_state_dict(loaded)
    for name, p in state_t.model.named_parameters():
        np.testing.assert_array_equal(sd[name].numpy(), p.detach().numpy())
    tx = jax_step.make_optimizer(BASE_LR, LR_STEPS)
    opt = jax_load_optimizer(ckpt, loaded, tx.init(loaded))
    adam = opt[0]
    assert int(adam.count) == COUNT + 1
    mu, nu = (params_to_state_dict(jax.tree.map(np.asarray, t))
              for t in (adam.mu, adam.nu))
    opt_state = state_t.optimizer.state
    for name, p in state_t.model.named_parameters():
        np.testing.assert_array_equal(mu[name].numpy(),
                                      opt_state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(nu[name].numpy(),
                                      opt_state[p]["exp_avg_sq"].numpy())


@pytest.mark.parametrize("objective", ["EPS", "RESIDUAL_X0"])
def test_parameter_order_is_torch_param_order(objective):
    """The port's UNet.parameters() order, which indexes the optimizer
    entry of its checkpoints, is sdm_tpu's torch_param_order."""
    cfg = _cfg(objective)
    _, params = _jax_params(cfg)
    flat = _flatten(params)
    names = dict(zip(flat.keys(), params_to_state_dict(params).keys()))
    want = [names[path] for path in torch_param_order(params)]
    assert [n for n, _ in UNet(**cfg).named_parameters()] == want


def test_lr_schedules_match_sdm_tpu():
    for base, steps in ((2e-4, 3), (1e-3, 1), (5e-5, 1000)):
        ours = port_step.reference_lr_schedule(base, steps)
        theirs = jax_step.reference_lr_schedule(base, steps)
        for count in range(0, 40):
            assert ours(count) == pytest.approx(float(theirs(count)),
                                                rel=1e-6)
    for resume_lr, steps, at in ((3e-4, 4, 10), (1e-4, 3, 0), (1e-3, 5, 7)):
        ours = port_step.resume_lr_schedule(resume_lr, steps, at)
        theirs = jax_step.resume_lr_schedule(resume_lr, steps, at)
        assert ours(at + 1) == pytest.approx(resume_lr)
        for count in range(at, at + 30):
            assert ours(count) == pytest.approx(float(theirs(count)),
                                                rel=1e-6)


def test_flip_is_per_image_along_width():
    """flip_imgs flips whole images along W (NHWC axis 2), each with its
    own draw: the loss equals the flip-free loss of one of the four
    flipped/unflipped pairs, and across seeds both outcomes occur."""
    cfg = _cfg("EPS")
    torch.manual_seed(0)
    net = UNet(**cfg)
    schedule = make_schedule("LINEAR", max_noise_step=T_MAX)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, "EPS").items()}

    def loss(flip, images, gen=None):
        fn = port_step.make_train_step(schedule, objective=Objective.EPS,
                                       max_actual_noise_step=T_MAX,
                                       flip_imgs=flip).loss_fn
        with torch.no_grad():
            return float(fn(net, dict(batch, image=images), gen))

    img = batch["image"]
    combos = {}
    for f0 in (False, True):
        for f1 in (False, True):
            imgs = img.clone()
            if f0:
                imgs[0] = imgs[0].flip(1)
            if f1:
                imgs[1] = imgs[1].flip(1)
            combos[(f0, f1)] = loss(False, imgs)
    seen = set()
    for seed in range(8):
        got = loss(True, img, torch.Generator().manual_seed(seed))
        match = [k for k, v in combos.items() if abs(v - got) < 1e-6]
        assert len(match) == 1
        seen.add(match[0])
    assert len(seen) > 1


# ----------------------------------------------- the step's extensions

# Cases: "<OBJECTIVE>[+min_snr][+accum2][+cfg_drop][+ema]". Two steps each,
# t and eps injected; "+cfg_drop" runs the port at cfg_drop_prob 1.0, whose
# mask zeroes every label vector whatever the draw, against sdm_tpu given
# the zeroed labels.
EXT_CASES = ["V", "EPS+min_snr", "V+min_snr", "X0+min_snr",
             "RESIDUAL_X0+min_snr", "EPS+accum2", "EPS+cfg_drop", "EPS+ema",
             "V+min_snr+accum2+ema"]
EMA_DECAY, GAMMA, ACCUM = 0.9, 5.0, 2
# After two steps a parameter may also differ in its last bit: Adam's
# second update starts from first ones that each package rounded.
LAST_BIT = float(np.finfo(np.float32).eps)


def _ext_kwargs(case):
    return dict(min_snr_gamma=GAMMA if "+min_snr" in case else None,
                grad_accum_steps=ACCUM if "+accum2" in case else 1,
                ema_decay=EMA_DECAY if "+ema" in case else None)


def _ext_batch(seed, case, port):
    batch = _batch(seed, case)
    if "+cfg_drop" in case:
        labels = np.random.default_rng(seed).standard_normal(
            (N, 2)).astype(np.float32)
        batch["labels"] = labels if port else np.zeros_like(labels)
    if "+accum2" in case:
        batch = {k: v.reshape((ACCUM, N // ACCUM) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _jax_steps(net, state, batches, objective, **kw):
    """sdm_tpu's step run on each batch in turn: ([(loss, grads)], params,
    EMA params), with the gradient captured as in _jax_step."""
    tx = jax_step.make_optimizer(BASE_LR, LR_STEPS)

    def update(g, s, p=None):
        updates, inner = tx.update(g, s[0], p)
        return updates, (inner, g)

    capture = optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    schedule = jax_make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                                 max_noise_step=T_MAX)
    step = jax.jit(jax_step.make_train_step(
        lambda p, x, t, l: net.apply({"params": p}, x, t, l), schedule,
        capture, objective=JaxObjective[objective], min_noise_step=1,
        max_actual_noise_step=T_MAX, cond_t=COND_T, lr_dim=LR_DIM, **kw))
    state = state.replace(opt_state=(
        state.opt_state, jax.tree.map(jnp.zeros_like, state.params)))
    out = []
    for batch in batches:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        out.append((float(metrics["loss"]), params_to_state_dict(
            jax.tree.map(np.asarray, state.opt_state[1]))))
    ema = (None if state.ema_params is None else params_to_state_dict(
        jax.tree.map(np.asarray, state.ema_params)))
    return out, params_to_state_dict(jax.tree.map(np.asarray,
                                                  state.params)), ema


@pytest.mark.parametrize("case", EXT_CASES)
def test_step_extensions_match_sdm_tpu(tmp_path, case):
    """The V objective, each objective's min-SNR weighting, grad_accum_steps
    2, cfg_drop_prob and ema_decay: losses and gradients of both steps, the
    parameters and the EMA after them."""
    objective = _objective(case)
    cfg = _cfg(objective)
    if "+cfg_drop" in case:
        cfg = dict(cfg, cond_dim=2)
    net, params = _jax_params(cfg)
    kw = _ext_kwargs(case)
    state_j = _nonzero_moments(params, 1)
    if kw["ema_decay"] is not None:
        state_j = state_j.replace(ema_params=jax.tree.map(jnp.array,
                                                          state_j.params))
    ckpt = _save_load(tmp_path, jax_checkpoint_dict(
        state_j.params, state_j.opt_state, lr=BASE_LR))
    batches = [_ext_batch(seed, case, port=False) for seed in (2, 3)]
    steps_j, params_j, ema_j = _jax_steps(net, state_j, batches, objective,
                                          **kw)

    torch.manual_seed(1)
    model = UNet(**cfg)
    load_params_from_checkpoint(ckpt, model, log=lambda *a: None)
    opt, lr_schedule = port_step.make_optimizer(model.parameters(), BASE_LR,
                                                LR_STEPS)
    state_t = port_step.create_train_state(
        model, opt, lr_schedule, ema=kw["ema_decay"] is not None)
    state_t.count = load_optimizer_from_checkpoint(ckpt, opt)
    step = port_step.make_train_step(
        make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                      max_noise_step=T_MAX),
        objective=Objective[objective], min_noise_step=1,
        max_actual_noise_step=T_MAX, cond_t=COND_T, lr_dim=LR_DIM,
        cfg_drop_prob=1.0 if "+cfg_drop" in case else 0.0, **kw)
    gen = torch.Generator().manual_seed(0)
    for seed, (loss_j, grads_j) in zip((2, 3), steps_j):
        batch = _ext_batch(seed, case, port=True)
        lr = state_t.schedule(state_t.count)
        loss_t = float(step(state_t, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, gen)["loss"])
        np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)
        scale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
        for name, p in state_t.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       grads_j[name].numpy(),
                                       rtol=GRAD_RTOL,
                                       atol=GRAD_OF_MAX * scale,
                                       err_msg=name)
    for name, p in state_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   params_j[name].numpy(), rtol=LAST_BIT,
                                   atol=2 * PARAM_ATOL_LR * lr, err_msg=name)
    if kw["ema_decay"] is None:
        assert state_t.ema is None and ema_j is None
        return
    assert list(state_t.ema) == [n for n, _ in
                                 state_t.model.named_parameters()]
    for name, e in state_t.ema.items():
        # The EMA moves by (1 - d) of each parameter's step.
        np.testing.assert_allclose(e.numpy(), ema_j[name].numpy(),
                                   rtol=LAST_BIT,
                                   atol=2 * PARAM_ATOL_LR * lr, err_msg=name)
    assert state_t.step == 2


def test_ema_checkpoints_resume_in_both_packages(tmp_path):
    """The port's checkpoint carries "ema" in the reference's names, which
    sdm_tpu's loader reads; sdm_tpu's "ema" loads back into a port state."""
    cfg = _cfg("EPS")
    _, params = _jax_params(cfg)
    torch.manual_seed(0)
    model = UNet(**cfg)
    opt, sched = port_step.make_optimizer(model.parameters(), BASE_LR,
                                          LR_STEPS)
    state = port_step.create_train_state(model, opt, sched, ema=True)
    for i, e in enumerate(state.ema.values()):
        e.add_(0.01 * (i + 1))         # the EMA apart from the parameters
    ckpt = _save_load(tmp_path, diffusion_checkpoint_dict(
        model, opt, lr=BASE_LR, ema=state.ema))
    assert set(ckpt) == {"model", "optimizer", "ema"}
    assert list(ckpt["ema"]) == list(ckpt["model"])
    skipped = []
    ema_j = jax_load_params(ckpt, params, log=skipped.append, key="ema")
    assert skipped == []
    sd = params_to_state_dict(ema_j)
    for name, e in state.ema.items():
        np.testing.assert_array_equal(sd[name].numpy(), e.numpy())

    back = _save_load(tmp_path, jax_checkpoint_dict(
        jax.tree.map(jnp.asarray, params), ema_params=ema_j))
    fresh = port_step.create_train_state(UNet(**cfg), opt, sched, ema=True)
    load_ema_from_checkpoint(back, fresh.ema, log=pytest.fail)
    for name, e in state.ema.items():
        np.testing.assert_array_equal(fresh.ema[name].numpy(), e.numpy())


@pytest.mark.parametrize("ema_decay,state_ema", [(EMA_DECAY, False),
                                                 (None, True)])
def test_step_refuses_a_state_that_disagrees_on_the_ema(ema_decay,
                                                        state_ema):
    """ema_decay and the state's EMA are one decision: a step with an EMA
    decay on a state without an EMA, or the other way round, raises before
    it touches the parameters."""
    cfg = _cfg("EPS")
    torch.manual_seed(0)
    model = UNet(**cfg)
    opt, sched = port_step.make_optimizer(model.parameters(), BASE_LR,
                                          LR_STEPS)
    state = port_step.create_train_state(model, opt, sched, ema=state_ema)
    before = [p.detach().clone() for p in model.parameters()]
    step = port_step.make_train_step(
        make_schedule("LINEAR", max_noise_step=T_MAX),
        objective=Objective.EPS, max_actual_noise_step=T_MAX,
        ema_decay=ema_decay)
    batch = _ext_batch(2, "EPS", port=True)
    with pytest.raises(ValueError, match="ema_decay"):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 0
    for p, b in zip(model.parameters(), before):
        assert torch.equal(p.detach(), b)
