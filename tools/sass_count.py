#!/usr/bin/env python3
"""Instruction counts of a kernel's loops from its SASS, and its ptxas
registers, for the port's CUDA library (trafficsimulation_tpu_torch/ops/
build.py builds it; `nvcc -Xptxas=-v` writes the build log).

    python3 tools/sass_count.py LIBRARY.so NAME [--log BUILD_LOG] [--dump F]

NAME is a substring of the kernel's mangled name (for K5 at B = 16:
`sdir_batched_kernelILi4ELi4E`).  A loop is a backward branch: the
instructions from its target to the branch, counted by opcode (the
mnemonic before its first dot), in all and outside the loops nested in
it.  The counts are static: a branch's two paths both count.  Needs
`cuobjdump` (CUDA toolkit)."""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
# instructions that do no arithmetic: memory, barriers, control
NON_ALU = ("LDS", "STS", "LDG", "STG", "LDGSTS", "LDGDEPBAR", "DEPBAR",
           "BAR", "BRA", "EXIT", "NOP", "LDC", "ULDC", "S2R", "S2UR",
           "BSSY", "BSYNC", "WARPSYNC", "MEMBAR", "CCTL", "ERRBAR")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")


def function_sass(so, name: str):
    """(mangled name, [(address, instruction text)], {label: address}) of
    the first function of the library whose name holds `name`."""
    text = subprocess.run([_cuobjdump(), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    fn, insns, labels, pending = None, [], {}, []
    for line in text.splitlines():
        if "Function :" in line:
            if fn is not None:
                break
            cand = line.split("Function :", 1)[1].strip()
            if name in cand:
                fn = cand
            continue
        if fn is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[p] = addr
            pending = []
            insns.append((addr, m.group(2).strip()))
    if fn is None:
        raise KeyError(f"no function with {name!r} in {so}")
    return fn, insns, labels


def opcode(insn: str) -> str:
    tok = insn.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0].split(".")[0] if tok else ""


def loops(insns, labels):
    """[{start, end, instructions, alu, opcodes, own, own_alu,
    own_opcodes}] of the backward branches, largest first; `own*` count
    the instructions of the loop outside the loops nested in it."""
    spans = []
    for addr, insn in insns:
        m = _BRA.search(insn)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                                16)
        if target is not None and target <= addr:
            spans.append((target, addr))

    def count(keep):
        hist = collections.Counter(opcode(i) for a, i in insns if keep(a))
        return (sum(hist.values()),
                sum(n for k, n in hist.items() if k not in NON_ALU),
                dict(hist.most_common()))

    out = []
    for t, e in spans:
        inner = [(a, b) for a, b in spans
                 if t <= a and b <= e and (a, b) != (t, e)]
        n, alu, ops = count(lambda a: t <= a <= e)
        own, own_alu, own_ops = count(lambda a: t <= a <= e and not any(
            x <= a <= y for x, y in inner))
        out.append({"start": hex(t), "end": hex(e), "instructions": n,
                    "alu": alu, "opcodes": ops, "own": own,
                    "own_alu": own_alu, "own_opcodes": own_ops})
    return sorted(out, key=lambda x: -x["instructions"])


def ptxas_info(log: str, name: str) -> dict:
    """Registers, stack, spills and shared memory of the first kernel whose
    mangled name holds `name`, from `ptxas -v` output."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            info = {"function": line.split("'")[1]}
            for nxt in lines[i + 1:i + 6]:
                if "Compiling entry function" in nxt:
                    break
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    info.update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    info["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", nxt)
                if m:
                    info["smem"] = int(m.group(1))
            return info
    raise KeyError(f"no ptxas entry for {name!r}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("library")
    ap.add_argument("name")
    ap.add_argument("--log", help="the build's ptxas -v log")
    ap.add_argument("--dump", help="write the function's SASS here")
    a = ap.parse_args()
    fn, insns, labels = function_sass(a.library, a.name)
    rep = {"function": fn, "instructions": len(insns),
           "loops": loops(insns, labels)}
    if a.log:
        with open(a.log) as f:
            rep["ptxas"] = ptxas_info(f.read(), a.name)
    if a.dump:
        with open(a.dump, "w") as f:
            f.write("\n".join(f"/*{x:04x}*/ {i}" for x, i in insns))
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
