"""Code-generation A/B of ``csrc/traverse.cu`` against another version of the
same file (for example the parent commit's): both are compiled for sm_90a
with the port's nvcc flags and ``-Xptxas -v``; for every kernel the two
share (by name) it prints registers, stack frame and spills, and whether
the SASS is the same instruction for instruction (and the first lines that
differ). A kernel that gained a last template argument since (``k<a, 128>``
here, ``k<a>`` there) is paired with its old name; where several
instantiations share that name, the one whose code is the old kernel's,
if one is, and the others are listed as new.

    git show <commit>:raytracer3_tpu_torch/csrc/traverse.cu > build/traverse_other.cu
    python -m raytracer3_tpu_torch.tools.kernel_ab build/traverse_other.cu

Needs the CUDA toolkit (nvcc, cuobjdump) and c++filt; exits non-zero if a
shared kernel differs in registers, stack, spills or SASS.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import shutil
import subprocess
import sys
import tempfile

from raytracer3_tpu_torch.ops import traverse_kernel as tk

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(os.path.dirname(tk._nvcc()), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def _demangle(names):
    out = subprocess.run([_tool("c++filt")], input="\n".join(names), capture_output=True, text=True, check=True)
    return dict(zip(names, out.stdout.splitlines()))


def _short(demangled: str) -> str:
    """'void (anonymous namespace)::traverse_kernel<false, true>(float ...)'
    → 'traverse_kernel<false, true>'."""
    head = demangled.split("(float")[0].split("(int")[0]
    return head.split("::")[-1].strip()


def compile_and_inspect(src: str, workdir: str, tag: str) -> dict:
    """{kernel: dict(regs, stack, spill_st, spill_ld, sass [instructions])}
    of ``src`` built with the port's flags."""
    flags = [f for f in tk.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(workdir, f"{tag}.cubin")
    p = subprocess.run([tk._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin, src],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stderr}")
    info, cur = {}, None
    for line in p.stderr.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = info.setdefault(m.group(1), {})
        elif cur is not None and _FRAME.search(line):
            st, sst, sld = map(int, _FRAME.search(line).groups())
            cur.update(stack=st, spill_st=sst, spill_ld=sld)
        elif cur is not None and _REGS.search(line):
            cur["regs"] = int(_REGS.search(line).group(1))
    sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            info.setdefault(fn, {})["sass"] = []
            continue
        if fn is not None:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins and not ins.startswith("."):
                info[fn]["sass"].append(ins)
    names = _demangle(list(info))
    return {_short(names[k]): v for k, v in info.items()}


_KEYS = ("regs", "stack", "spill_st", "spill_ld", "sass")


def _pairs(this: dict, other: dict) -> dict:
    """{kernel of this version: its kernel in ``other``}: the same name, or
    the name without its last template argument where only this version
    has that argument (module docstring)."""
    pairs, renamed = {}, {}
    for name in this:
        if name in other:
            pairs[name] = name
            continue
        m = re.match(r"^(.*<.*), [^,<>]+>$", name)
        if m and m.group(1) + ">" in other and m.group(1) + ">" not in this:
            renamed.setdefault(m.group(1) + ">", []).append(name)
    for was, names in renamed.items():
        same = [n for n in sorted(names) if all(this[n].get(k) == other[was].get(k) for k in _KEYS)]
        pairs[(same or sorted(names))[0]] = was
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other version of csrc/traverse.cu")
    ap.add_argument("--show", type=int, default=12, help="differing SASS lines to print per kernel")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        other = compile_and_inspect(args.other, d, "other")
        this = compile_and_inspect(tk._SRC, d, "this")
    bad = 0
    pairs = _pairs(this, other)
    for name in sorted(this):
        was = pairs.get(name)
        if was is None:
            k = this[name]
            print(f"{name}: new in this version (regs {k.get('regs')}, stack {k.get('stack')}, spills "
                  f"{k.get('spill_st')}/{k.get('spill_ld')}, {len(k.get('sass', []))} instructions)")
            continue
        a, b = other[was], this[name]
        res = {k: (a.get(k), b.get(k)) for k in ("regs", "stack", "spill_st", "spill_ld")}
        same_sass = a.get("sass") == b.get("sass")
        same = all(x == y for x, y in res.values()) and same_sass
        bad += not same
        na, nb = len(a.get("sass", [])), len(b.get("sass", []))
        print(f"{name}{'' if was == name else f' (was {was})'}: "
              + ", ".join(f"{k} {x}->{y}" for k, (x, y) in res.items())
              + f", SASS {'identical' if same_sass else 'DIFFERS'} ({na} -> {nb} instructions)")
        if not same_sass:
            diff = list(difflib.unified_diff(a.get("sass", []), b.get("sass", []), lineterm="", n=0))
            changed = [x for x in diff if x[:1] in "+-" and not x.startswith(("+++", "---"))]
            print(f"  {len(changed)} lines differ; the first:")
            for line in changed[:args.show]:
                print("   ", line)
    print("all shared kernels identical" if not bad else f"{bad} shared kernels differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
