"""Compare the SASS of a CUDA source of the port between two checkouts,
kernel by kernel.

    python3 sass_diff.py OTHER_CHECKOUT [SOURCE] [--rename OLD=NEW ...]

SOURCE names a library of ``raytracingtest_tpu_torch._build`` by its
builder (``brick`` for ``brick_lib``, csrc/brick_trace.cu, the default;
``shade``, ``tile``, ...). Each checkout builds the library with its own
``_build`` (nvcc for sm_90a), ``cuobjdump -sass`` dumps both, and each
kernel of OTHER_CHECKOUT is held against the kernel of the same name here
(``--rename`` maps a kernel's name there to its name here, as ``ptxas``
names them, e.g. ``esvo_stackless_kernel<0>``). A kernel is "identical" when its instructions
and encodings are; else its differing instructions are printed, in pairs
(there | here), up to SHOW of them. Needs nvcc and cuobjdump: it runs on a
machine with the card's toolkit.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHOW = 16  # differing instructions printed a kernel


def build(checkout, source):
    """Path of `source`'s library as `checkout` builds it."""
    code = (f"from raytracingtest_tpu_torch import _build; "
            f"print(getattr(_build, '{source}_lib')()._name)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"building {source} in {checkout} failed:\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def cuobjdump():
    return shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def kernels(lib):
    """kernel name -> its instructions, each (text, encoding)."""
    dump = subprocess.run([cuobjdump(), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name, body = {}, None, []
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, body = short(m.group(1)), []
            out[name] = body
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;?\s*/\* (0x[0-9a-f]+) \*/", line)
        if ins and name:
            body.append([ins.group(1), ins.group(2)])
        elif name and body and re.match(r"\s*/\* (0x[0-9a-f]+) \*/", line):
            body[-1][1] += line.split()[1]
    return out


def short(mangled):
    """A mangled kernel name as ptxas reports it: name<0,1,256>."""
    pos = mangled.find("N") + 1   # _ZN: a nested name, length-prefixed parts
    while m := re.match(r"\d+", mangled[pos:]):
        end = pos + m.end() + int(m.group())
        ident, pos = mangled[pos + m.end():end], end
        if ident.endswith("_kernel"):
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
            return ident + ("<" + ",".join(args) + ">" if args else "")
    return mangled


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("source", nargs="?", default="brick")
    ap.add_argument("--rename", action="append", default=[])
    args = ap.parse_args()
    rename = dict(r.split("=", 1) for r in args.rename)
    theirs = kernels(build(os.path.abspath(args.other), args.source))
    ours = kernels(build(HERE, args.source))
    for name in sorted(theirs):
        here = rename.get(name, name)
        a, b = theirs[name], ours.get(here)
        if b is None:
            print(f"[sass] {name}: not in this checkout")
        elif a == b:
            print(f"[sass] {name} -> {here}: identical ({len(a)} instructions)")
        else:
            diff = [(i, x[0], y[0]) for i, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]]
            print(f"[sass] {name} -> {here}: DIFFERS ({len(a)} vs {len(b)} instructions, "
                  f"{len(diff)} of the first {min(len(a), len(b))} differ)")
            for i, x, y in diff[:SHOW]:
                print(f"[sass]   #{i}: {x}  |  {y}")
    print(f"[sass] only in this checkout: {sorted(set(ours) - {rename.get(n, n) for n in theirs})}")


if __name__ == "__main__":
    main()
