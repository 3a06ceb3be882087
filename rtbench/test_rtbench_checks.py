"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped): the program passes, and the control in bfloat16 and each fault
of the timed path that a cell can have come out not correct. The metrics'
readers on a made-up trace."""

import pytest
import torch

from rtb import harness, readers, spec, trace

TINY = {
    "surface.fit-4views": dict(width=32, height=32, views=4, rays_per_step=2048),
    "surface.fit-random": dict(width=32, height=32, views=4, rays_per_step=2048),
    "volumetric.serve-4k": dict(width=48, height=30, check_span=[0, 4], check_pixels=256),
}
FAULTS = {"fit": ("unchanged", "half_batch"), "serve": ("alter",)}
CASES = [(c, "program", "none") for c in TINY] + [(c, "control", "none") for c in TINY] + [
    (c, "program", f) for c in TINY for f in FAULTS[spec.cell(c).traffic["mode"]]]


def tiny(name):
    c = spec.cell(name)
    c.config = dict(c.config, depth=5)
    c.traffic = dict(c.traffic, **TINY[name])
    return c


@pytest.mark.parametrize("name,mode,fault", CASES)
def test_run_on_the_cpu(name, mode, fault):
    torch.set_num_threads(1)
    out = harness.run(tiny(name), 2 ** 31 + 11, 0.2, False, check_mode=mode,
                      fault=fault, device="cpu")
    assert out["correct"] is (mode == "program" and fault == "none"), out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec.cell(name).limits)
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(out["metrics"]) == names


def _run(calls=2, complete=True):
    r = harness.Run()
    r.window_s, r.rays, r.setup_s = 2.0, 400e6, 9.5
    r.frame_s = [0.001 * i for i in range(1, 101)]
    r.call_host_s = [0.002, 0.004]
    r.synced_host_s = [0.001, 0.003]
    k = [("void brick_trace_kernel<true, false, 256>(Tree, Rays, Out, int)", 0.0, 0.004),
         ("void brick_trace_kernel<true, false, 256>(Tree, Rays, Out, int)", 0.1, 0.004),
         ("shade_bwd_kernel(float const*)", 0.2, 0.001),
         ("seg_sum_kernel(float const*)", 0.3, 0.001),
         ("brick_trace_multi_staged_kernel<false>(Tree)", 0.4, 0.002),
         ("brick_trace_multi_staged_kernel<false>(Tree)", 0.5, 0.002)]
    r.stretch = trace.Stretch(window_s=0.5, busy_s=0.4, complete=complete, launches=6,
                              lost=0 if complete else 1, kernels=k, device_ops=[],
                              idle_gaps=[])
    r.stretch_calls = calls
    w = dict(rays=1 << 20, top_steps=25 << 20, dda_steps=7 << 20, table_bytes=10 ** 6,
             k=4, hits=400000, touched=300000, leaves=10 ** 6)
    r.work = [w] * calls
    return r


def test_readers_on_a_made_up_trace():
    r = _run()
    read = lambda name: spec.reader(name)(r)
    assert read("train_mrays_s") == 200.0
    assert read("setup_s") == 9.5
    assert read("frame_p95_ms") == pytest.approx(95.05)
    assert read("host_call_ms.serve") == pytest.approx(3.0)
    assert read("host_call_ms.fit") == pytest.approx(2.0)
    assert read("device_idle_share.fit") == pytest.approx(20.0)
    from rtb import work
    least = work.least_time(*work.brick_trace(r.work[0]))[0]
    assert read("brick_trace_roofline.fit") == pytest.approx(100 * least / 0.004)
    least = work.least_time(*work.brick_trace_multi(r.work[0]))[0]
    assert read("brick_trace_multi_roofline.serve") == pytest.approx(100 * least / 0.002)
    least = work.least_time(*work.backward(r.work[0]))[0]
    assert read("backward_roofline.fit") == pytest.approx(100 * 2 * least / 0.002)


def test_readers_leave_out_what_they_cannot_read():
    assert spec.reader("brick_trace_roofline.fit")(_run(complete=False)) is None
    assert spec.reader("brick_trace_roofline.fit")(_run(calls=3)) is None
    r = _run()
    r.stretch = None
    assert spec.reader("device_idle_share.serve")(r) is None
    assert readers.mean_ms([]) is None


def test_short_kernel_names():
    assert trace.short_name("void f<a, (b)>(int)") == "f<a, (b)>"
    assert trace.short_name("Memset (Device)") == "Memset"


@pytest.mark.card
@pytest.mark.parametrize("name", list(TINY))
def test_tiny_run_on_the_card(card, name):
    """A whole run on the card at a tiny size: the kernels' outputs pass."""
    out = harness.run(tiny(name), 2 ** 31 + 13, 0.2, True, device=str(card))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
