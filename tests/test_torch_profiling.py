"""The port's profiling helpers and single-process start-up against the JAX
package's: ``iter_stats`` and ``traversal_roofline`` (at an explicit
bandwidth) equal, the rays/s counter waiting for the card, the
torch.profiler paths, and ``init_from_env``'s status."""

import os

import numpy as np
import pytest
import torch

from raytracingtest_tpu.parallel import multihost as jax_multihost
from raytracingtest_tpu.utils import profiling as jax_profiling

from raytracingtest_tpu_torch.parallel import multihost
from raytracingtest_tpu_torch.utils import profiling
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", [0, 1])
def test_iter_stats_equal(seed):
    iters = np.random.default_rng(seed).integers(0, 300, 5000).astype(np.int32)
    want = jax_profiling.iter_stats(iters)
    assert profiling.iter_stats(iters) == want
    assert profiling.iter_stats(torch.from_numpy(iters)) == want


@pytest.mark.parametrize("n,depth,iters,gbps", [(1 << 20, 10, 60.0, 1000.0),
                                                (1000, 6, 12.5, 3350.0)])
def test_traversal_roofline_equal(n, depth, iters, gbps):
    assert (profiling.traversal_roofline(n, depth, iters, hbm_gbps=gbps)
            == jax_profiling.traversal_roofline(n, depth, iters, hbm_gbps=gbps))


def test_roofline_defaults_to_the_h100():
    assert profiling.H100_HBM_GBPS == 3350.0
    assert (profiling.traversal_roofline(1 << 20, 10, 60.0)
            == profiling.traversal_roofline(1 << 20, 10, 60.0, hbm_gbps=3350.0))


def test_rays_per_second_counter():
    import time
    c = profiling.RaysPerSecond()
    with c.frame(1000, "cpu"):
        time.sleep(0.01)
    assert c.frames == 1 and c.rays == 1000
    assert 0 < c.rays_per_s < 1000 / 0.01 * 2
    assert "Mrays/s" in c.summary()


def test_rays_per_second_waits_for_the_card(monkeypatch):
    """A CUDA frame is synchronised before the clock starts and before it
    stops (here with the synchronisation recorded, not run)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    c = profiling.RaysPerSecond()
    with c.frame(10, "cuda:0"):
        assert len(calls) == 1
    assert calls == [torch.device("cuda", 0)] * 2
    with c.frame(10, "cpu"):
        pass
    assert len(calls) == 2 and c.frames == 2


def test_device_op_breakdown_and_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.float32)
    rows = profiling.device_op_breakdown(lambda t: torch.sort(t * 2.0), x, calls=2)
    assert isinstance(rows, list)
    for name, ms, count in rows:
        assert ms >= 0 and count >= 1
    if not torch.cuda.is_available():
        assert rows == []   # no CUDA kernel ran
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.sort(x)
    assert os.listdir(tmp_path / "trace")


def test_init_from_env_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("RAYT_MULTIHOST", raising=False)
    assert multihost.init_from_env() == jax_multihost.init_from_env()


@pytest.mark.parametrize("var,value", [("JAX_COORDINATOR_ADDRESS", "localhost:1234"),
                                       ("RAYT_MULTIHOST", "auto")])
def test_init_from_env_refuses_a_coordinator(monkeypatch, var, value):
    """A configured coordinator starts a world (tests/test_torch_multihost.py
    runs one), on the card unless a device is named: with no card and none
    named it is refused before any rendezvous, never run on the CPU."""
    import torch.distributed as dist
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("RAYT_MULTIHOST", raising=False)
    monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_from_env()
    assert not dist.is_initialized()
