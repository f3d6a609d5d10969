"""Driver `train_step`: the program's training step
(train/step.py::make_train_step, its model and Adam state from
make_optimizer and create_train_state), fed batches of seeded uint8
images made on the device, each step's loss read after the next step is
launched (the trainer's overlapped loss fetch).

Set-up builds the one state, runs its first three steps through the same
call and feed as the window (on three different batches), and reads what
the check compares: each step's loss, the first gradient as Adam got it
(its first moment after one step over 1 - beta1, copied to the host) and,
after the third step, the norm of each parameter's change from the seeded
weights. The window then trains on; a traced run traces `traced_steps`
more steps after it.

The check runs the plain float32 reference over those three steps (the
same weights, images and the step's own draws of t and eps, which it
repeats from the same generator in the step's order), `rows` images at a
time, after the program's state is freed. Compared: `loss_gap`, the
largest relative gap of the three losses; `grad_gap` and `update_gap`,
the worst leaf's gap of norms against the reference's norm of that leaf
or of the median leaf, the larger; `grad_err`, the worst leaf's norm of
the difference of the first gradients against the same floor. A norm
averages rounding out (its gap is second order in it), so the norms'
gaps alone do not tell bfloat16 from float8; the difference does. Leaves whose reference gradient is
under a thousandth of the median leaf's (dead weights) are left out of
`update_gap`: Adam moves them by round-off alone.
"""

from __future__ import annotations

import time

from gpubench import flops, harness
from gpubench.counters import Counts
from gpubench.reference import diffusion as ref
from gpubench.reference.unet import strict_fp32

CHECK_STEPS = 3
DEAD_LEAF = 1e-3


def batches(wl: dict, cfg: dict, seed: int, device):
    """The feed: `distinct_batches` batches of uint8 images, each row
    its own draw."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "images"))
    size = cfg["image_size"]
    return [torch.randint(0, 256, (wl["batch"], size, size, 3),
                          generator=gen, device=device, dtype=torch.uint8)
            for _ in range(wl["distinct_batches"])]


def draws_generator(seed: int, device):
    import torch
    return torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, "draws"))


def build(cfg: dict, wl: dict, params, device):
    """(state, step_fn) of the program for this cell."""
    import torch
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.train.step import (create_train_state,
                                          make_optimizer, make_train_step)
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[cfg["dtype"]]
    with torch.device(device):     # initialised on the card, not the host
        net = UNet(**harness.unet_kwargs(cfg), dtype=dtype, use_kernels=True)
    net = net.to(device, memory_format=torch.channels_last)
    net.load_state_dict(params, strict=True)
    opt, lr_schedule = make_optimizer(net.parameters(), wl["lr"],
                                      wl["lr_steps"])
    state = create_train_state(net, opt, lr_schedule)
    schedule = make_schedule(cfg["noise_scheduler"], beta_1=cfg["beta_1"],
                             beta_T=cfg["beta_T"],
                             max_noise_step=cfg["max_noise_step"],
                             device=device)
    step_fn = make_train_step(
        schedule, objective=Objective[cfg["objective"]],
        min_noise_step=wl["min_noise_step"],
        max_actual_noise_step=wl["max_actual_noise_step"],
        flip_imgs=False, cond_t=cfg.get("cond_t"), lr_dim=cfg.get("lr_dim"))
    return state, step_fn


def leaf_norms(tensors) -> dict:
    import torch
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def run(ctx: dict) -> dict:
    import torch
    spec, seed, seconds = ctx["spec"], ctx["seed"], ctx["seconds"]
    cfg, wl, device = spec["config"], spec["workload"], ctx["device"]
    cuda = device.type == "cuda"
    counts = Counts()
    phases = {}

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = ctx["clock"].since()

    params = harness.make_params(cfg, seed, device)
    mark("weights")
    state, step_fn = build(cfg, wl, params, device)
    mark("model_built")
    if ctx.get("fault"):
        step_fn = ctx["fault"](state, step_fn)
    feed = batches(wl, cfg, seed, device)
    gen = draws_generator(seed, device)
    named = dict(state.model.named_parameters())

    def step(i):
        counts.own["steps"] += 1
        return step_fn(state, {"image": feed[i % len(feed)]}, gen)

    # The first three steps: warm-up, and what the check compares.
    losses = [float(step(0)["loss"])]
    mark("first_step")
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    first = {k: (state.optimizer.state[p]["exp_avg"] / (1 - beta1)).cpu()
             for k, p in named.items()}
    for i in range(1, CHECK_STEPS):
        losses.append(float(step(i)["loss"]))
    updates = leaf_norms({k: p.detach() - params[k]
                          for k, p in named.items()})
    del params
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = ctx["clock"].since()
    phases["checked_steps"] = setup_s

    # The window.
    window_losses, n_steps, prev = [], 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out = step(CHECK_STEPS + n_steps)
        n_steps += 1
        if prev is not None:
            window_losses.append(float(prev["loss"]))
        prev = out
    window_losses.append(float(prev["loss"]))
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    summary = None
    if ctx["trace"]:
        # `traced_steps` more steps through the same call, traced.
        from gpubench.trace import Tracer
        tracer = Tracer(counts.read)
        tracer.start()
        for i in range(wl["traced_steps"]):
            out = step(CHECK_STEPS + n_steps + i)
        window_losses.append(float(out["loss"]))
        tracer.stop()
        summary = tracer.summary()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del state, step_fn, feed, named, prev, out
    if cuda:
        torch.cuda.empty_cache()

    checks, notes = check(cfg, wl, seed, device, losses, first, updates)
    checks["window_losses_finite"] = {
        "value": sum(1 for v in window_losses if not v == v
                     or abs(v) == float("inf")), "limit": 0}
    images = n_steps * wl["batch"]
    h = cfg["image_size"]
    record = {"images": images, "chips": 1, "window_s": window_s,
              "window_peak_bytes": peak,
              "forward_flops": flops.unet_forward_flops(cfg, h, h, 1),
              "kernel_work": flops.kernel_work(
                  cfg, h, h, wl["batch"], 2, flops.WHOLE_S_MAX,
                  backward=True)}
    return {"metrics": {"trained_img_per_s": images / window_s},
            "attempted": n_steps, "failed": 0, "checks": checks,
            "notes": notes,
            "record": record, "setup_s": setup_s, "peak_bytes": peak,
            "phases": phases,
            "trace": summary}


def reference_steps(cfg, wl, seed, device, quant=None, keep=None):
    """The plain float32 reference's three steps from the seeded weights:
    (losses, the first gradient (host tensors), leaf norms of the change
    after the third step). `keep` leaves out all but the first rows of
    each batch (a planted fault)."""
    import torch
    params = harness.make_params(cfg, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    feed = batches(wl, cfg, seed, device)
    gen = draws_generator(seed, device)
    abar = ref.alpha_bar(cfg["beta_1"], cfg["beta_T"], cfg["max_noise_step"],
                         device)
    adam = ref.Adam(params, wl["lr"])
    n, size = wl["batch"], cfg["image_size"]
    losses, first = [], None
    with strict_fp32():
        for i in range(CHECK_STEPS):
            # The step's draws, in its order: t, then eps.
            t = torch.randint(wl["min_noise_step"],
                              wl["max_actual_noise_step"], (n,),
                              generator=gen, device=device)
            eps = torch.randn((n, size, size, 3), generator=gen,
                              device=device)
            loss, grads = ref.sr_loss_and_grads(
                params, cfg, abar, feed[i], t, eps, cfg["cond_t"],
                cfg["lr_dim"], wl["ref_rows"], quant, keep)
            losses.append(loss)
            if first is None:
                first = {k: g.cpu() for k, g in grads.items()}
            with torch.no_grad():
                adam.step(params, grads)
            del grads
    updates = leaf_norms({k: params[k] - start[k] for k in params})
    return losses, first, updates


def worst(gaps: dict, n: int = 3) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def compare(wl, losses, first, updates, ref_losses, ref_first, ref_updates):
    """(the compared numbers, each beside its limit; the worst leaves of
    each per-leaf number, for the log)."""
    import torch
    grads, ref_grads = leaf_norms(first), leaf_norms(ref_first)
    vals = sorted(ref_grads.values())
    median = vals[len(vals) // 2]
    live = [k for k, v in ref_grads.items() if v >= DEAD_LEAF * median]
    floor = {k: max(v, median) for k, v in ref_grads.items()}
    err = {k: float(torch.linalg.vector_norm(first[k] - ref_first[k]))
           / floor[k] for k in ref_first}
    gap = {k: harness.rel_gap(grads[k], ref_grads[k], median)
           for k in ref_grads}
    umed = sorted(ref_updates.values())[len(ref_updates) // 2]
    ugap = {k: harness.rel_gap(updates[k], ref_updates[k], umed)
            for k in live}
    limits = wl["checks"]
    checks = {
        "loss_gap": {"value": max(harness.rel_gap(a, b, 0.0)
                                  for a, b in zip(losses, ref_losses)),
                     "limit": limits["loss_gap"]},
        "grad_err": {"value": max(err.values()),
                     "limit": limits["grad_err"]},
        "grad_gap": {"value": max(gap.values()),
                     "limit": limits["grad_gap"]},
        "update_gap": {"value": max(ugap.values()),
                       "limit": limits["update_gap"]},
    }
    notes = {"grad_err": worst(err), "grad_gap": worst(gap),
             "update_gap": worst(ugap),
             "median_leaf": {"grad_err": sorted(err.values())[len(err) // 2],
                             "grad_gap": sorted(gap.values())[len(gap) // 2],
                             "update_gap": sorted(ugap.values())[
                                 len(ugap) // 2]}}
    return checks, notes


def check(cfg, wl, seed, device, losses, first, updates):
    ref_losses, ref_first, ref_updates = reference_steps(cfg, wl, seed,
                                                         device)
    return compare(wl, losses, first, updates, ref_losses, ref_first,
                   ref_updates)
