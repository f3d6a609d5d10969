"""The benchmark's plain reference against the program's plain path at a
tiny size on the CPU, the same seeded weights handed to both: the U-Net,
the DDIM and cold samplers, and the SR loss and gradients."""

import pytest
import torch

from conftest import TINY
from gpubench import harness
from gpubench.reference import diffusion as ref
from gpubench.reference.unet import fp8_round, unet

CFGS = {name: dict(harness.load_json(harness.HERE, "configs",
                                     f"{name}.json"), **TINY, lr_dim=8)
        for name in ("flagship128", "sr256")}
DEV = torch.device("cpu")


def program(cfg, params):
    from sdm_tpu_torch.models import UNet
    net = UNet(**harness.unet_kwargs(cfg), use_kernels=False)
    net.load_state_dict(params, strict=True)
    return net.eval()


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_unet_matches_program(name):
    cfg = CFGS[name]
    params = harness.make_params(cfg, 5, DEV)
    x = torch.randn(3, 16, 16, cfg["in_channel"],
                    generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1, 500, 999])
    with torch.no_grad():
        want = program(cfg, params)(x, t)
        got = unet(params, cfg, x, t)
        low = unet(params, cfg, x, t, fp8_round)
    assert rel(got, want) < 1e-5
    assert rel(low, want) > 1e-3       # the control departs


def test_state_dict_names_and_init():
    from sdm_tpu_torch.models import UNet
    cfg = CFGS["flagship128"]
    params = harness.make_params(cfg, 5, DEV)
    net = UNet(**harness.unet_kwargs(cfg), use_kernels=False)
    sd = net.state_dict()
    assert list(sd) == list(params)
    for k, v in sd.items():
        assert v.shape == params[k].shape
        owner = k.rsplit(".", 1)[0]
        w = sd.get(f"{owner}.weight")
        if w is not None and w.ndim >= 2:
            # PyTorch's default bound, 1/sqrt(fan_in), for weight and bias.
            fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(w)
            assert float(params[k].abs().max()) <= fan_in ** -0.5
            assert float(params[k].abs().max()) > 0.9 * fan_in ** -0.5


def test_samplers_match_program():
    from sdm_tpu_torch.diffusion.samplers import cold_sample, ddim_sample
    from sdm_tpu_torch.ops.schedules import make_schedule
    sched = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=1000)
    abar = ref.alpha_bar(5e-3, 9e-3, 1000, DEV)
    steps = ref.skip_steps(1, 1000, 100)
    noise = torch.randn(2, 16, 16, 3,
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        cfg = CFGS["flagship128"]
        params = harness.make_params(cfg, 6, DEV)
        net = program(cfg, params)
        want = ddim_sample(lambda x, t, lab: net(x, t), sched, noise,
                           ddim_step_size=100)
        assert rel(ref.ddim(params, cfg, abar, noise, steps), want) < 1e-4
        cfg = CFGS["sr256"]
        params = harness.make_params(cfg, 6, DEV)
        net = program(cfg, params)
        lr = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(
            3)) * 2 - 1
        up = ref.area(lr, 16, 16)
        cond = ref.q_sample(abar[250], up, noise)
        want = up + cold_sample(lambda x, t, lab: net(x, t), sched, noise,
                                noise, skip_step_size=100, cond_img=cond)
        got = ref.sr_sample(params, cfg, abar, noise, lr, steps, 250)
        assert rel(got, want) < 1e-4


def test_sr_loss_and_grads_match_program():
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.train.step import make_train_step
    cfg = CFGS["sr256"]
    params = harness.make_params(cfg, 7, DEV)
    net = program(cfg, params).train()
    sched = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=1000)
    step = make_train_step(sched, objective=Objective.RESIDUAL_X0,
                           cond_t=250, lr_dim=8)
    g = torch.Generator().manual_seed(4)
    imgs = torch.randint(0, 256, (4, 16, 16, 3), generator=g,
                         dtype=torch.uint8)
    t = torch.randint(1, 1000, (4,), generator=g)
    eps = torch.randn(4, 16, 16, 3, generator=g)
    loss = step.loss_fn(net, {"image": imgs, "t": t, "eps": eps}, None)
    loss.backward()
    abar = ref.alpha_bar(5e-3, 9e-3, 1000, DEV)
    got_loss, grads = ref.sr_loss_and_grads(params, cfg, abar, imgs, t, eps,
                                            250, 8, rows=3)
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    want = {name: p.grad if p.grad is not None else torch.zeros_like(p)
            for name, p in net.named_parameters()}
    norms = sorted(float(g.norm()) for g in want.values())
    median = norms[len(norms) // 2]
    for name, g in want.items():
        assert float((grads[name] - g).norm()) <= 1e-4 * max(
            float(g.norm()), median), name
