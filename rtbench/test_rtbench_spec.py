"""BENCHMARK.json against the contract's shape, each cell's files found by
name, the harness's imports, and the refusal to run without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from rtb import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        for cell in m["workloads"]:
            e2e = spec.cell(cell).end_to_end
            assert m["moves"] in {x["name"] for x in e2e}
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.cell(cell)
    assert c.traffic["mode"] in harness.DRIVERS
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)


def test_files_live_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("rtbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
    for root, _dirs, files in os.walk(spec.RTBENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), spec.RTBENCH)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


IMPORTS = """
import sys
sys.path[:0] = [{here!r}, {root!r}]
import run, prove
from rtb import camera, harness, readers, refbuild, refshade, refwalk, spec, trace, traffic, work
for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
import raytracingtest_tpu_torch
from raytracingtest_tpu_torch.models import InverseRenderer, SurfaceRenderer, VolumetricRenderer
from raytracingtest_tpu_torch.ops.octree_device import build_svo_device
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def test_no_jax_in_what_the_harness_imports():
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS.format(here=spec.RTBENCH, root=spec.ROOT)],
        capture_output=True, text=True, timeout=120, cwd=spec.ROOT, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)
    assert "raytracingtest_tpu_torch" in top


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracingtest_tpu_torch_extra", sys)
    assert "raytracingtest_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raytracingtest_tpu.diff", sys)
    assert harness.forbidden_modules() == ["raytracingtest_tpu"]


def test_refuses_to_run_without_a_card():
    cmd = [sys.executable, "rtbench/run.py", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=spec.ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
