"""Multi-process start-up from the environment: the single-process case.

Port of ``raytracingtest_tpu/parallel/multihost.py``'s ``init_from_env``.
With no coordinator configured it returns the JAX package's status dict
for one process. A configured coordinator (JAX_COORDINATOR_ADDRESS, or
RAYT_MULTIHOST) raises: the port trains on one device until the sharded
steps (``parallel/render_sharded.py`` and the rest of ``parallel/``) are
ported, the same gap as ``InverseRenderer(n_devices > 1)``.
"""

from __future__ import annotations

import os


def init_from_env() -> dict:
    """The status of a single-process run when neither
    JAX_COORDINATOR_ADDRESS nor RAYT_MULTIHOST is set; raises
    NotImplementedError when either is."""
    mode = os.environ.get("RAYT_MULTIHOST", "")
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if coord or mode:
        raise NotImplementedError(
            f"multi-process start-up (JAX_COORDINATOR_ADDRESS={coord!r}, "
            f"RAYT_MULTIHOST={mode!r}) is not ported: the port runs one "
            "process on one device until parallel/ is ported (ROADMAP.md, "
            "Queue 1)")
    return {
        "initialized": False,
        "process_index": 0,
        "process_count": 1,
        "reason": "single-host (no JAX_COORDINATOR_ADDRESS / "
                  "RAYT_MULTIHOST)",
    }
