"""The loop probe's two forms and take's launch path, on one NVIDIA GPU, in a
process of its own.

    env PYTHONPATH=. python3 gather_probe.py [look] [forms]

Builds ``csrc/shade.cu`` and the launcher (``csrc/launch.cpp``). Both phases
by default:

  look   the SASS of the loop probe's two kernels (``cuobjdump -sass``; each
         kernel's instructions by opcode on a line, then the whole listing,
         a line an instruction); the first form (``loop_probe_serial``)
         alone and in turns on chip_smoke.py's LOOP_TIMED cases; take_1d's
         launch path part by part, before and now (chip_smoke.take_parts),
         at the main path's size, and take_1d (both paths) against
         index_select in turns at both sizes. The main path's size: the
         depth-10 `terrain` SVO built on the card (``build_svo_device``, the
         host build's structure bit for bit), its leaf densities gathered at
         the hit leaves (misses: leaf 0) of bench.py's 1024² frame.
  forms  both forms against loop_probe_plain bitwise (chip_smoke.loop_parity),
         in turns and alone on every LOOP_TIMED case, and the floors at the
         SM clock read under load.

chip_smoke.py runs the same functions in its [parity], [timing], [wrapper],
[profile] and [bound].
"""

import collections
import os
import re
import shutil
import subprocess
import sys

import torch

import chip_smoke as cs
from raytracingtest_tpu_torch import _build
from raytracingtest_tpu_torch.ops import camera, gather, octree_device, traverse_cuda
from raytracingtest_tpu_torch.scenes import get_scene

LOOP_KERNELS = ("loop_probe_kernel", "loop_probe_ranged_kernel")


def sass(lib_path):
    """kernel name -> its SASS lines, for the loop probe's two kernels."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            short = kernel_name(m.group(1))
            name = short if short in LOOP_KERNELS else None
            if name:
                out[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4})\*/\s*(.*?)\s*;", line)
        if ins and name:
            out[name].append(f"{ins.group(1)}  {ins.group(2)}")
    return out


def kernel_name(mangled):
    """The loop kernel's own name in a mangled one."""
    m = re.search(r"(loop_probe\w*_kernel)", mangled)
    return m.group(1) if m else mangled


def opcodes(lines):
    count = collections.Counter()
    for line in lines:
        op = re.sub(r"^@!?U?P\w+\s+", "", line.split("  ", 1)[1]).split()[0]
        count[op.split(".")[0]] += 1
    return ", ".join(f"{k} {v}" for k, v in count.most_common())


def main_size(dev):
    """(leaf densities, safe hit leaves) of bench.py's frame at depth 10."""
    svo = octree_device.build_svo_device(get_scene("terrain"), 10, device=dev)
    cam = camera.Camera(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                        fov_y_deg=50.0, width=1024, height=1024)
    o, d = cam.rays(dev)
    hit = traverse_cuda.trace_cuda(svo, o, d).hit_leaf
    return svo.leaf_density, torch.where(hit >= 0, hit, 0)


def look(dev, card, inp):
    lib = _build.shade_lib()._name
    listing = sass(lib)
    for name, lines in listing.items():
        cs.say(f"[sass] {name}: {len(lines)} instructions: {opcodes(lines)}")
    for name, lines in listing.items():
        cs.say("\n".join(f"[sass-listing] {name} {line}" for line in lines))
    cs.say("[build] shade.cu, ptxas -v: " + "; ".join(
        f"{k} {r} registers, {sp} spilled"
        for k, r, sp, _sm in cs.ptxas_report(_build.build_log("shade"))))
    turns = cs.in_turns({k: v for k, v in cs.loop_variants(inp).items()
                         if k.startswith("loop_serial")}, rounds=3, reps=20)
    cs.say(f"[timing] {card}: loop_probe_serial (the first form), ms in turns "
           f"(three rounds of 20): " + ", ".join(
               f"{k[len('loop_serial '):]} {cs.med_p80(v)[0]:.4f}" for k, v in turns.items()))
    alone = {}
    for case in cs.LOOP_TIMED:
        args = cs.loop_call(inp, case)
        rows = {e.key: cs.dev_us(e) / e.count
                for e in cs.traced_kernels(lambda a=args: gather.loop_probe_serial(*a), 20)
                if e.count}
        alone[case] = cs.kernel_us(rows, "loop_probe_kernel")[0]
    cs.say(f"[profile] {card}: loop_probe_serial us alone (20 calls traced): " + ", ".join(
        f"{c} {cs.us_or(v)}" for c, v in alone.items()))
    clock = cs.sm_clock_mhz(
        lambda: gather.loop_probe_serial(*cs.loop_call(inp, (2048, 0))), 1000)
    cs.say(f"[bound] SM clock under load {clock[0]:.0f} MHz, maximum {clock[1]:.0f}")

    big_table, big_idx = main_size(dev)
    t1 = torch.arange(16384, dtype=torch.int32, device=dev)
    i1 = cs.probe_idx((8, 128), 16384, dev)
    for what, table, idx in (("the main path's size", big_table, big_idx),
                             ("(8,128) of 16,384 rows", t1, i1)):
        flat = idx.reshape(-1)
        parts = cs.take_parts(dev, table, idx)
        cs.say(f"[wrapper] {card}: take_1d at {what}, host us a call (median of "
               f"three rounds of 3000): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
        turns = cs.in_turns({
            "before": lambda t=table, i=idx: cs.take_1d_old_path(t, i),
            "now": lambda t=table, i=idx: gather.take_1d(t, i),
            "index_select": lambda t=table, f=flat: torch.index_select(t, 0, f)})
        cs.say(f"[timing] {card}: take_1d at {what}, ms in turns (three rounds of "
               f"50): " + ", ".join(f"{k} {cs.med_p80(v)[0]:.4f}" for k, v in turns.items()))


def forms(card, inp):
    err = dict(loop_probe=0.0, loop_probe_serial=0.0)
    cs.loop_parity(inp, err)
    turns = cs.in_turns(cs.loop_variants(inp), rounds=3, reps=20)
    m = {k: cs.med_p80(v)[0] for k, v in turns.items()}
    cs.say(f"[timing] {card}: loop_probe, ms in turns (three rounds of 20), the "
           f"ranged form against its first form: " + ", ".join(
               f"{c} {m[f'loop {c}']:.4f} against {m[f'loop_serial {c}']:.4f}"
               for c in cs.LOOP_TIMED))
    alone = {}
    for case in cs.LOOP_TIMED:
        args = cs.loop_call(inp, case)
        rows = {e.key: cs.dev_us(e) / e.count for e in cs.traced_kernels(
            lambda a=args: (gather.loop_probe(*a), gather.loop_probe_serial(*a)), 20)
            if e.count}
        alone[case] = cs.kernel_us(rows, "loop_probe_ranged_kernel", "loop_probe_kernel")
    cs.say(f"[profile] {card}: us alone (20 rounds traced), the ranged form against "
           f"its first form: " + ", ".join(
               f"{c} {cs.us_or(a)} against {cs.us_or(b)}" for c, (a, b) in alone.items()))
    now, peak = cs.sm_clock_mhz(
        lambda: gather.loop_probe_serial(*cs.loop_call(inp, (2048, 0))), 1000)
    f = cs.loop_floors(inp["x"].numel(), 2048, 8, now)
    cs.say(f"[bound] {card}: 2048 trips at {now:.0f} MHz (maximum {peak:.0f}): issue "
           f"floor {f['issue_ms']:.5f} ms, latency floor {f['latency_ms']:.5f} ms, the "
           f"{f['binds']} floor binds")


def main(phases):
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cs.say(card)
    _build.shade_lib()
    _build.launch_lib()
    inp = cs.loop_inputs(dev)
    if "look" in phases:
        look(dev, card, inp)
    if "forms" in phases:
        forms(card, inp)


if __name__ == "__main__":
    main(sys.argv[1:] or ["look", "forms"])
