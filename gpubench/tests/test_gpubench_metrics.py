"""The per-layer metrics' arithmetic on synthetic traces: the busy union
and idle share, the idle gaps named by the host, the kernels' roofline
share, the per-call times, and a reader that finds nothing returns
nothing."""

import pytest

from gpubench import flops, harness
from gpubench.peaks import least_seconds
from gpubench.trace import (Summary, family, idle_gaps, name_gaps,
                            union_seconds)

SR = harness.load_json(harness.HERE, "configs", "sr256.json")


def metric(name):
    return harness.load_module("metrics", name).read


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_seconds(iv) == 3.0
    assert idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    named = name_gaps([(2.0, 3.0), (4.0, 5.0)],
                      [("aten::item", 1.9, 2.9), ("aten::to", 2.9, 3.2),
                       ("cudaMemcpy", 4.2, 4.9)])
    assert named == {"aten::item": 1.0, "cudaMemcpy": 1.0}


def test_families():
    assert family("adagn_grid<bf16>") == "adagn (port)"
    assert family("stream_apply_wgmma<dv_pass>") == "streaming dV (port)"
    assert family("sm90_xmma_fprop_implicit_gemm") == "conv (cuDNN)"
    assert family("ncclDevKernel_AllReduce") == "nccl"
    assert family("elementwise_kernel") == "other (elementwise, copies)"


def trace(counts):
    # Two busy seconds in a window of 2.5: 1 s of the port's AdaGN, 0.5 s
    # of its attention, 0.5 s of cuDNN.
    kernels = [("adagn_grid", 0.0, 1.0), ("attn_apply_wgmma", 1.0, 0.5),
               ("xmma_fprop_conv", 1.5, 0.5)]
    return Summary(kernels, [("aten::item", 2.0, 2.5)], 2.5, counts)


def test_idle_share_and_per_call():
    tr = trace({"unet_calls": 4, "steps": 2})
    assert metric("device_idle_share.serve")({}, tr) == pytest.approx(20.0)
    assert metric("unet_call_ms.serve")({}, tr) == pytest.approx(500.0)
    assert metric("conv_ms.serve")({}, tr) == pytest.approx(125.0)
    assert metric("conv_ms.train")({}, tr) == pytest.approx(250.0)
    assert tr.breakdown()["device_ops"][0] == ["adagn_grid", 1.0]


def test_kernels_roofline():
    work = flops.kernel_work(SR, 256, 256, 16, 2, flops.WHOLE_S_MAX, True)
    counts = {"fused_adagn": 32, "fused_attention_block": 8,
              "streaming_dv": 2}              # two U-Net calls
    least = 2 * sum(least_seconds(o, b) for fn in work for o, b in work[fn])
    tr = trace(counts)
    got = metric("kernels_roofline.train")({"kernel_work": work}, tr)
    assert got == pytest.approx(100.0 * least / 1.5)   # port: 1.5 s


def test_nothing_to_read_gives_nothing():
    empty = Summary([], [], 1.0, {})
    assert metric("device_idle_share.train")({}, empty) is None
    assert metric("kernels_roofline.serve")({"kernel_work": {}}, empty) \
        is None
    assert metric("unet_call_ms.serve")({}, None) is None
    assert metric("batch_fill.serve")(
        {"engine": {"images": 0, "padded_images": 0}}, None) is None


def test_record_metrics():
    rec = {"images": 640, "window_s": 10.0, "chips": 1,
           "forward_flops": 703.7e9, "calls_per_chain": 51,
           "engine": {"images": 30, "padded_images": 2},
           "window_peak_bytes": 3 * 2 ** 30}
    assert metric("step_mfu.train")(rec, None) == pytest.approx(
        100 * 3 * 640 * 703.7e9 / 10.0 / 989e12)
    assert metric("unet_mfu.serve")(rec, None) == pytest.approx(
        100 * 640 * 51 * 703.7e9 / 10.0 / 989e12)
    assert metric("batch_fill.serve")(rec, None) == pytest.approx(93.75)
    assert metric("peak_mem_gib.train")(rec, None) == pytest.approx(3.0)


def test_tracer_runs_on_the_calling_thread():
    """OnThread starts and stops the tracer on the thread that calls the
    wrapped method, at its first call after each ask."""
    import threading
    import time

    from gpubench.trace import OnThread

    class Worker:
        def dispatch(self, x):
            return x + 1

    seen = []

    class FakeTracer:
        def start(self):
            seen.append(("start", threading.current_thread().name))

        def stop(self):
            seen.append(("stop", threading.current_thread().name))

    w = Worker()
    hook = OnThread(FakeTracer(), w, "dispatch")
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            assert w.dispatch(1) == 2
            time.sleep(0.001)
    th = threading.Thread(target=loop, name="device-worker")
    th.start()
    try:
        assert hook.ask("start", 5.0)
        assert hook.ask("stop", 5.0)
    finally:
        stop.set()
        th.join(5.0)
    assert not th.is_alive()
    assert seen == [("start", "device-worker"), ("stop", "device-worker")]
