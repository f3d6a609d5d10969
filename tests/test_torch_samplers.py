"""The port's samplers (sdm_tpu_torch/diffusion/samplers.py), its v
parameterization (diffusion/vpred.py) and classifier-free guidance
(diffusion/guidance.py) against sdm_tpu's, with the per-step noise injected
(`zs`) so both sides see the same draws. The model is a cheap analytic eps
function on both sides: the U-Net's parity is held by test_torch_model.py,
and the whole served chain by test_torch_serving.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.diffusion import guidance as jax_guidance
from sdm_tpu.diffusion import samplers as jax_samplers
from sdm_tpu.diffusion import vpred as jax_vpred
from sdm_tpu.ops.schedules import make_schedule as jax_make_schedule
from sdm_tpu_torch.diffusion import guidance, samplers, vpred
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

    def x0_model(x, t, labels):
        return x
    x0_model.model_output = "x0"       # neither "eps" nor "v"
    for sample in (samplers.ddim_sample, samplers.dpmpp_sample,
                   samplers.heun_sample):
        with pytest.raises(ValueError, match="model_output"):
            sample(x0_model, ts, x, max_noise=T)
    with pytest.raises(ValueError, match="inpainting needs"):
        samplers.dpmpp_sample(_torch_model, ts, x, max_noise=T,
                              inpaint_known=x)


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


# ------------------------------------------------- extensions (ROADMAP 6)

# Normwise limit of the second-order samplers and the v and CFG paths: fp32
# in another evaluation order.
NORMWISE = 1e-5
T_EXT = 50
# The schedules' T, above the sampled T_EXT: at t = T the cosine alpha is
# 4e-8, and Heun's first ratio alpha_t'/alpha_T amplifies fp32 rounding
# about 1e6 times in either package.
T_SCHED = 60


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("min_noise,max_noise,n", [
    (1, 1000, 2), (1, 1000, 11), (1, 1000, 51), (1, 50, 6), (3, 40, 9),
    (7, 7, 1)])
def test_karras_step_list_matches(name, min_noise, max_noise, n):
    js = jax_make_schedule(name, max_noise_step=max(max_noise, 50))
    ts = make_schedule(name, max_noise_step=max(max_noise, 50))
    assert samplers.karras_step_list(min_noise, max_noise, n, ts) == \
        jax_samplers.karras_step_list(min_noise, max_noise, n, js)


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("min_noise,max_noise,size", [
    (1, 1000, 20), (1, 1000, 100), (1, 500, 50), (501, 1000, 20)])
def test_karras_steps_matching_matches(name, min_noise, max_noise, size):
    js = jax_make_schedule(name, max_noise_step=1000)
    ts = make_schedule(name, max_noise_step=1000)
    got = samplers.karras_steps_matching(min_noise, max_noise, size, ts)
    assert got == jax_samplers.karras_steps_matching(min_noise, max_noise,
                                                     size, js)
    assert got[0] == max_noise and got[-1] == min_noise


def _ext_inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    known = rng.uniform(-1, 1, shape).astype(np.float32)
    mask = (rng.uniform(size=shape[1:3] + (1,)) < 0.5).astype(np.float32)
    pnoise = rng.standard_normal(shape).astype(np.float32)
    return x, known, mask, pnoise


def _pair(fn_name, variant):
    """(sdm_tpu's sampler call, the port's) for a variant of the inputs."""
    x, known, mask, pnoise = _ext_inputs(5)
    jm, tm = _jax_model, _torch_model
    if "v" in variant:
        jm, tm = jax_vpred.tag_v(jm), vpred.tag_v(tm)
    kw = dict(min_noise=1, max_noise=T_EXT, step_size=7)
    if "steps" in variant:
        kw["steps"] = [50, 31, 17, 8, 3, 1]
    jkw, tkw = dict(kw), dict(kw)
    if "inpaint" in variant:
        jkw.update(inpaint_known=jnp.asarray(known),
                   inpaint_mask=jnp.asarray(mask),
                   inpaint_noise=jnp.asarray(pnoise))
        tkw.update(inpaint_known=torch.from_numpy(known),
                   inpaint_mask=torch.from_numpy(mask),
                   inpaint_noise=torch.from_numpy(pnoise))
    if fn_name == "ddim":
        for d in (jkw, tkw):
            d["ddim_step_size"] = d.pop("step_size")
    return ((getattr(jax_samplers, f"{fn_name}_sample"), jm, jnp.asarray(x),
             jkw),
            (getattr(samplers, f"{fn_name}_sample"), tm, torch.from_numpy(x),
             tkw))


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("fn_name", ["dpmpp", "heun"])
@pytest.mark.parametrize("variant", ["plain", "steps", "inpaint", "v",
                                     "v+steps+inpaint"])
def test_second_order_samplers_match(name, fn_name, variant):
    """DPM-Solver++(2M) and Heun: the uniform skip list and `steps=`,
    inpainting and a v-tagged model, normwise against sdm_tpu."""
    js = jax_make_schedule(name, max_noise_step=T_SCHED)
    ts = make_schedule(name, max_noise_step=T_SCHED)
    (jf, jm, jx, jkw), (tf, tm, tx, tkw) = _pair(fn_name, variant)
    ref = np.asarray(jf(jm, js, jx, **jkw))
    ours = tf(tm, ts, tx, **tkw)
    assert ours.dtype == torch.float32 and ours.shape == tx.shape
    assert _normwise(ours.numpy(), ref) <= NORMWISE


@pytest.mark.parametrize("variant", ["v", "inpaint", "v+steps+inpaint"])
def test_ddim_v_and_inpainting_match(variant):
    js = jax_make_schedule("COSINE", max_noise_step=T_SCHED)
    ts = make_schedule("COSINE", max_noise_step=T_SCHED)
    (jf, jm, jx, jkw), (tf, tm, tx, tkw) = _pair("ddim", variant)
    ref = np.asarray(jf(jm, js, jx, **jkw))
    assert _normwise(tf(tm, ts, tx, **tkw).numpy(), ref) <= NORMWISE


def test_inpainting_keeps_the_known_pixels():
    """The final x0 equals the known image where the mask is 1."""
    _, ts = _schedules("LINEAR")
    x, known, mask, pnoise = _ext_inputs(6)
    out = samplers.dpmpp_sample(
        _torch_model, ts, torch.from_numpy(x), max_noise=T, step_size=4,
        inpaint_known=torch.from_numpy(known),
        inpaint_mask=torch.from_numpy(mask),
        inpaint_noise=torch.from_numpy(pnoise)).numpy()
    keep = np.broadcast_to(mask, out.shape) == 1
    np.testing.assert_array_equal(out[keep], known[keep])


def test_ddpm_v_model_matches():
    js, ts = _schedules("COSINE")
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    zs = rng.standard_normal((T,) + SHAPE).astype(np.float32)
    ref = jax_samplers.ddpm_sample(jax_vpred.tag_v(_jax_model), js,
                                   jnp.asarray(x), max_noise=T,
                                   zs=jnp.asarray(zs))
    ours = samplers.ddpm_sample(vpred.tag_v(_torch_model), ts,
                                torch.from_numpy(x), max_noise=T,
                                zs=torch.from_numpy(zs))
    assert _normwise(ours.numpy(), np.asarray(ref)) <= NORMWISE


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
@pytest.mark.parametrize("fn", ["v_target", "eps_from_v", "x0_from_v",
                                "as_eps_model"])
def test_vpred_functions_match(name, fn):
    js = jax_make_schedule(name, max_noise_step=T_EXT)
    ts = make_schedule(name, max_noise_step=T_EXT)
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([1, T_EXT], np.int32)
    if fn == "as_eps_model":
        cond = rng.standard_normal(SHAPE).astype(np.float32)
        xa = np.concatenate([a, cond], axis=-1)    # x_t plus a cond image
        ref = jax_vpred.as_eps_model(_jax_model, js)(
            jnp.asarray(xa), jnp.asarray(t), None)[..., :3]
        ours = vpred.as_eps_model(_torch_model, ts)(
            torch.from_numpy(xa), torch.from_numpy(t), None)[..., :3]
    else:
        ref = getattr(jax_vpred, fn)(js, jnp.asarray(t), jnp.asarray(a),
                                     jnp.asarray(b))
        ours = getattr(vpred, fn)(ts, torch.from_numpy(t),
                                  torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_vpred_round_trip_and_tags():
    """x0 and eps come back from (x_t, v); tag_v wraps without mutating,
    and the factory forms take the module."""
    ts = make_schedule("COSINE", max_noise_step=T_EXT)
    rng = np.random.default_rng(9)
    x0, eps = (torch.from_numpy(rng.standard_normal(SHAPE)
                                .astype(np.float32)) for _ in range(2))
    t = torch.tensor([3, 40])
    x_t = ts.q_sample(x0, t, eps)
    v = vpred.v_target(ts, t, x0, eps)
    torch.testing.assert_close(vpred.x0_from_v(ts, t, x_t, v), x0,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vpred.eps_from_v(ts, t, x_t, v), eps,
                               rtol=1e-5, atol=1e-5)
    tagged = vpred.tag_v(_torch_model)
    assert tagged.model_output == "v"
    assert not hasattr(_torch_model, "model_output")
    net = torch.nn.Identity()
    fn = vpred.tag_v_factory(lambda m: lambda x, t, l: m(x))(net)
    assert fn.model_output == "v" and fn(x0, t, None) is x0
    eps_fn = vpred.as_eps_factory(lambda m: lambda x, t, l: m(x), ts)(net)
    torch.testing.assert_close(eps_fn(x_t, t, None),
                               vpred.eps_from_v(ts, t, x_t, x_t))


def _label_model_jax(x, t, labels):
    lab = jnp.atleast_2d(labels).sum(-1)      # (N,), or (1,) unbatched
    return 0.3 * x + lab[:, None, None, None] + 0.01 * t.astype(
        jnp.float32)[:, None, None, None]


def _label_model_torch(x, t, labels):
    lab = labels.reshape(-1, labels.shape[-1]).sum(-1)
    return 0.3 * x + lab[:, None, None, None] + 0.01 * t.to(
        torch.float32)[:, None, None, None]


@pytest.mark.parametrize("scale", [0.0, 1.0, 3.0])
@pytest.mark.parametrize("batched_labels", [False, True])
def test_cfg_model_fn_matches(scale, batched_labels):
    """One guided call: conditional rows first, zero-label rows second,
    combined in fp32; a (cond_dim,) label vector broadcasts over the
    batch."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    lab = rng.standard_normal((SHAPE[0], 4) if batched_labels else (4,)
                              ).astype(np.float32)
    t = np.array([7], np.int32)
    ref = jax_guidance.cfg_model_fn(_label_model_jax, scale)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(lab))
    ours = guidance.cfg_model_fn(_label_model_torch, scale)(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(lab))
    assert _normwise(ours.numpy(), np.asarray(ref)) <= NORMWISE


def test_cfg_model_fn_keeps_the_v_tag_and_needs_labels():
    guided = guidance.cfg_model_fn(vpred.tag_v(_label_model_torch), 2.0)
    assert guided.model_output == "v"
    assert guidance.cfg_model_fn(_torch_model, 1.0) is _torch_model
    with pytest.raises(ValueError, match="label conditioning"):
        guidance.cfg_model_fn(_torch_model, 2.0)(torch.zeros(SHAPE),
                                                 torch.tensor([1]), None)


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_dropout_labels(prob):
    """Probability 0 keeps every label vector, 1 zeroes every one (as
    sdm_tpu's, whatever the draw); in between each row is kept or zeroed
    whole, from the generator."""
    lab = torch.arange(1, 65, dtype=torch.float32).reshape(32, 2)
    got = guidance.dropout_labels(lab, torch.Generator().manual_seed(0),
                                  prob)
    ref = np.asarray(jax_guidance.dropout_labels(
        jnp.asarray(lab.numpy()), jax.random.PRNGKey(0), prob))
    kept = (got == lab).all(dim=1)
    assert bool(((got == 0).all(dim=1) | kept).all())
    if prob in (0.0, 1.0):
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert 0 < int(kept.sum()) < 32
    assert guidance.dropout_labels(None, None, 0.5) is None
