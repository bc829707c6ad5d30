#!/usr/bin/env python3
"""Build the CUDA sources of one or two trees and print every kernel's
registers and spills (ptxas -v) side by side, to show what an edit of a
source did to them.

    python3 scripts/ptxas_report.py [--before DIR] [--after DIR] [--out FILE] [--sass]

``--after`` defaults to this tree, ``--before`` to none (the after tree's
report alone); a tree is a checkout (e.g. a parent commit unpacked with
``git archive``), built in its own ``sarssl_torch/_build``. Exits non-zero if
a kernel of the after tree spills more than it did before (without
``--before``: if one spills at all). With ``--before`` and ``--sass`` it also
compares the two trees' machine code (``cuobjdump -sass``) of every kernel
both hold, line for line with the anonymous namespace's name masked, and
names each kernel whose code differs.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BUILD = ("import json, sys\n"
         "from sarssl_torch.kernels._build import build_all\n"
         "json.dump(build_all(), sys.stdout)\n")


def ptxas_logs(root: Path) -> dict:
    """Each source's ptxas report, from a fresh build in ``root``."""
    for old in (root / "sarssl_torch" / "_build").glob("lib*.so"):
        if not old.name.startswith("libism"):
            old.unlink()
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=root, capture_output=True, text=True,
                         check=True).stdout
    return json.loads(out)


def _demangle(mangled: str) -> str:
    """``name<dtype, template ints>`` of a kernel in an anonymous namespace
    (``_ZN<n><namespace><m><name>I<args>E...``, the namespace's name a hash
    that differs from build to build)."""
    ns = re.match(r"_ZN(\d+)", mangled)
    rest = mangled[ns.end() + int(ns.group(1)):]
    length = re.match(r"\d+", rest)
    at = length.end() + int(length.group())
    return _label(rest[length.end():at], rest[at:])


def _label(name: str, targs: str) -> str:
    """``name<dtype, template ints>`` from a kernel's name and its mangled
    template arguments (``Li64E`` an int, ``Lb1E`` a bool, printed b1);
    ``name`` alone for a kernel that is no template."""
    targs = re.match(r"I(.*?)Ev", targs)  # up to the function type
    if targs is None:
        return name
    targs = targs.group(1)
    parts = ["bf16"] if "nv_bfloat16" in targs else ["f32"] if targs.startswith("f") else []
    parts += [("b" if t == "b" else "") + v for t, v in re.findall(r"L([ib])(\d+)E", targs)]
    return f"{name}<{','.join(parts)}>"


def kernels(logs: dict) -> dict:
    """(source, kernel<template args>) -> (registers, spill stores, spill
    loads) of every entry function in the logs."""
    res = {}
    for source, log in logs.items():
        name = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = (source, _demangle(entry.group(1)))
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and name:
                res.setdefault(name, [None, 0, 0])[1:] = [int(g) for g in spill.groups()]
            used = re.search(r"Used (\d+) registers", line)
            if used and name:
                res.setdefault(name, [None, 0, 0])[0] = int(used.group(1))
    return {k: tuple(v) for k, v in res.items()}


def sass(root: Path) -> dict:
    """(library, kernel<template args>) -> its SASS lines, from
    ``cuobjdump -sass`` of each library ``root``'s build holds, the
    anonymous namespace's name (a hash that differs from build to build)
    masked."""
    from sarssl_torch.kernels._build import cuda_tool

    res = {}
    for lib in sorted((root / "sarssl_torch" / "_build").glob("lib*.so")):
        stem = re.sub(r"_[0-9a-f]{16}$", "", lib.stem[3:])
        if not (root / "sarssl_torch" / "csrc" / f"{stem}.cu").exists():
            continue  # a host library (csrc/ism.cpp)
        text = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            name, _, body = part.partition("\n")
            if not name.startswith("_ZN"):
                continue
            res[(stem, _demangle(name.strip()))] = re.sub(r"_GLOBAL__N__\w+", "NS", body).split(
                "\n")
    return res


def r_spill(report) -> int:
    """Bytes a kernel's report spills (stores and loads)."""
    return report[1] + report[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path)
    ap.add_argument("--after", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--out", type=Path, help="also write the table here")
    ap.add_argument("--sass", action="store_true",
                    help="with --before, compare the kernels' machine code too")
    args = ap.parse_args()
    after = kernels(ptxas_logs(args.after.resolve()))
    before = kernels(ptxas_logs(args.before.resolve())) if args.before else {}
    code = {}
    if args.before and args.sass:
        code = {t: sass(r.resolve()) for t, r in (("before", args.before), ("after", args.after))}
    lines = [f"{'source':18} {'kernel':44} {'before':>14} {'after':>14}"]
    for key in sorted(set(after) | set(before)):
        cell = {t: (f"{r[0]} regs" + (f" +{r[1]}/{r[2]}B spill" if r[1] or r[2] else ""))
                if r else "-" for t, r in (("b", before.get(key)), ("a", after.get(key)))}
        mark = "" if before.get(key) == after.get(key) or not args.before else "  *"
        lines.append(f"{key[0]:18} {key[1]:44} {cell['b']:>14} {cell['a']:>14}{mark}")
    spills = [k for k, r in after.items() if r[1] or r[2]]
    gained = [k for k in spills if r_spill(after[k]) > r_spill(before.get(k, (0, 0, 0)))]
    same = sum(before.get(k) == r for k, r in after.items())
    lines.append(f"{len(after)} kernels after, {len(before)} before; {same} unchanged; "
                 f"spilling after: {spills or 'none'}; spilling more than before: "
                 f"{gained or 'none'}")
    if code:
        both = sorted(set(code["before"]) & set(code["after"]))
        differ = [k for k in both if code["before"][k] != code["after"][k]]
        lines.append(f"SASS: {len(both)} kernels in both trees, {len(both) - len(differ)} "
                     f"identical line for line; differing: {differ or 'none'}")
    text = "\n".join(lines)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    sys.exit(1 if gained else 0)


if __name__ == "__main__":
    main()
