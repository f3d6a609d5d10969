"""The port's samplers (sdm_tpu_torch/diffusion/samplers.py) against
sdm_tpu's, with the per-step noise injected (`zs`) so both sides see the
same draws. The model is a cheap analytic eps function on both sides: the
U-Net's parity is held by test_torch_model.py, and the whole served chain
by test_torch_serving.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.diffusion import samplers as jax_samplers
from sdm_tpu.ops.schedules import make_schedule as jax_make_schedule
from sdm_tpu_torch.diffusion import samplers
from sdm_tpu_torch.ops.schedules import make_schedule

# Trajectories of fp32 updates in another evaluation order.
TRAJ_TOL = dict(atol=1e-4, rtol=1e-3)
T = 20
SHAPE = (2, 4, 4, 3)


def _jax_model(x, t, labels):
    return 0.3 * x + 0.01 * t.astype(jnp.float32)[:, None, None, None]


def _torch_model(x, t, labels):
    return 0.3 * x + 0.01 * t.to(torch.float32)[:, None, None, None]


def _schedules(name):
    return (jax_make_schedule(name, max_noise_step=T),
            make_schedule(name, max_noise_step=T))


@pytest.mark.parametrize("min_noise,max_noise,size",
                         [(1, 1000, 20), (1, 20, 4), (3, 20, 5), (5, 5, 1)])
def test_ddim_step_list_matches(min_noise, max_noise, size):
    assert samplers.ddim_step_list(min_noise, max_noise, size) == \
        jax_samplers.ddim_step_list(min_noise, max_noise, size)


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("min_noise", [1, 3])
def test_ddim_eta0_matches(name, min_noise):
    """eta = 0; min_noise 1 returns x0 at step 1, 3 returns x_t."""
    js, ts = _schedules(name)
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    ref = jax_samplers.ddim_sample(_jax_model, js, jnp.asarray(x),
                                   min_noise=min_noise, max_noise=T,
                                   ddim_step_size=4)
    ours = samplers.ddim_sample(_torch_model, ts, torch.from_numpy(x),
                                min_noise=min_noise, max_noise=T,
                                ddim_step_size=4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TRAJ_TOL)


def test_ddim_eta_with_zs_matches():
    js, ts = _schedules("LINEAR")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    n_steps = len(samplers.ddim_step_list(1, T, 4))
    zs = rng.standard_normal((n_steps - 1,) + SHAPE).astype(np.float32)
    ref = jax_samplers.ddim_sample(_jax_model, js, jnp.asarray(x),
                                   max_noise=T, ddim_step_size=4, eta=0.7,
                                   zs=jnp.asarray(zs))
    ours = samplers.ddim_sample(_torch_model, ts, torch.from_numpy(x),
                                max_noise=T, ddim_step_size=4, eta=0.7,
                                zs=torch.from_numpy(zs))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TRAJ_TOL)


def test_ddpm_with_zs_matches():
    js, ts = _schedules("LINEAR")
    rng = np.random.default_rng(2)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    zs = rng.standard_normal((T,) + SHAPE).astype(np.float32)
    ref = jax_samplers.ddpm_sample(_jax_model, js, jnp.asarray(x),
                                   max_noise=T, zs=jnp.asarray(zs))
    ours = samplers.ddpm_sample(_torch_model, ts, torch.from_numpy(x),
                                max_noise=T, zs=torch.from_numpy(zs))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TRAJ_TOL)


def test_samplers_refuse_missing_noise_and_v_models():
    _, ts = _schedules("LINEAR")
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        samplers.ddpm_sample(_torch_model, ts, x, max_noise=T)
    with pytest.raises(ValueError):
        samplers.ddim_sample(_torch_model, ts, x, max_noise=T, eta=0.5)

    def v_model(x, t, labels):
        return x
    v_model.model_output = "v"
    with pytest.raises(NotImplementedError):
        samplers.ddim_sample(v_model, ts, x, max_noise=T)


def test_ddpm_generator_draws_are_reproducible():
    _, ts = _schedules("LINEAR")
    x = torch.ones(SHAPE)
    a, b = (samplers.ddpm_sample(_torch_model, ts, x, max_noise=T,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_x0_model(x, t, labels):
    return jnp.tanh(0.5 * x[..., :3]) + 0.01 * t.astype(
        jnp.float32)[:, None, None, None]


def _torch_x0_model(x, t, labels):
    return torch.tanh(0.5 * x[..., :3]) + 0.01 * t.to(
        torch.float32)[:, None, None, None]


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("steps", [None, [20, 13, 6, 2, 1]])
@pytest.mark.parametrize("with_cond", [False, True])
def test_cold_sample_matches(name, steps, with_cond):
    """The uniform skip list and the `steps` override, with and without a
    conditioning image concatenated on the channels (the SR form), the
    shared noise injected."""
    js, ts = _schedules(name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    cond = rng.standard_normal(SHAPE).astype(np.float32) if with_cond \
        else None
    ref = jax_samplers.cold_sample(
        _jax_x0_model, js, jnp.asarray(x), jnp.asarray(noise), min_noise=1,
        max_noise=T, skip_step_size=3, steps=steps,
        cond_img=None if cond is None else jnp.asarray(cond))
    ours = samplers.cold_sample(
        _torch_x0_model, ts, torch.from_numpy(x), torch.from_numpy(noise),
        min_noise=1, max_noise=T, skip_step_size=3, steps=steps,
        cond_img=None if cond is None else torch.from_numpy(cond))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TRAJ_TOL)


def test_cold_sample_refuses_v_models():
    _, ts = _schedules("LINEAR")

    def v_model(x, t, labels):
        return x

    v_model.model_output = "v"
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="x0-predicting"):
        samplers.cold_sample(v_model, ts, x, x, max_noise=T)
