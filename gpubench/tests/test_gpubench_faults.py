"""A run's check with the timed path broken underneath: the drivers run
on the CPU at a tiny size (the look for a card is the only step left out),
each with one fault planted, and `correct` comes out false. A sound run of
the same size is the witness that each fault moves the compared number."""

import pytest
import torch

from conftest import cpu_run, tiny_spec
from gpubench import harness

SEED = 2 ** 31 + 977


def state_unchanged(state, step_fn):
    """Each step computes its update and returns the state as it was."""
    def step(st, batch, gen):
        before = [p.detach().clone() for p in st.model.parameters()]
        out = step_fn(st, batch, gen)
        with torch.no_grad():
            for p, b in zip(st.model.parameters(), before):
                p.copy_(b)
        return out
    return step


def half_batch(state, step_fn):
    """Each step's mean over the first half of the batch's rows only."""
    def step(st, batch, gen):
        n = batch["image"].shape[0]
        return step_fn(st, {"image": batch["image"][: n // 2]}, gen)
    return step


def altered_answer(server):
    """Every answer's first image is its second one."""
    engine = server.engine
    inner = engine.finalize

    def finalize(handle):
        results = inner(handle)
        for r in results:
            if r.shape[0] >= 2:
                r[0] = r[1]
        return results
    engine.finalize = finalize


def model_adds_nothing(server):
    """Each sampler step leaves its state as it was: the U-Net's output is
    zero, so the trajectory only rescales the noise."""
    for entry in server.engine._entries:
        net = entry["net"]
        inner = net.forward
        net.forward = lambda x, t=None, cond=None: inner(x, t, cond) * 0


@pytest.fixture(scope="module")
def sound():
    return {name: cpu_run(tiny_spec(name), SEED)["checks"]
            for name in ("sr256.train_b64", "flagship128.serve_mixed")}


@pytest.mark.parametrize("fault,number", [(state_unchanged, "update_gap"),
                                          (half_batch, "loss_gap")])
def test_training_faults_fail(sound, fault, number):
    checks = cpu_run(tiny_spec("sr256.train_b64"), SEED, fault)["checks"]
    assert not harness.judge(checks)
    assert checks[number]["value"] > checks[number]["limit"]
    assert checks[number]["value"] > 10 * sound["sr256.train_b64"][number][
        "value"]


@pytest.mark.parametrize("fault", [altered_answer, model_adds_nothing])
def test_serving_faults_fail(sound, fault):
    spec = tiny_spec("flagship128.serve_mixed")
    spec["workload"]["mix"]["sizes"] = [2]     # every answer holds two
    checks = cpu_run(spec, SEED, fault, seconds=3.0)["checks"]
    assert not harness.judge(checks)
    assert checks["image_gap"]["value"] > 10 * sound[
        "flagship128.serve_mixed"]["image_gap"]["value"]
