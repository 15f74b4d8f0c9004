#!/usr/bin/env python3
"""Instruction counts of the port's kernels from their SASS, on a machine
with the CUDA toolkit.

    python3 tools/sass_loops.py [NAME_PATTERN ...]

Builds the kernel library (``ops/_kernels.build``), disassembles it with
the toolkit's ``cuobjdump -sass`` and, for every kernel whose mangled
name matches one of the regular expressions given (all kernels without
one), prints its static instruction count, the most frequent opcodes,
and each loop (a backward branch and the instructions it jumps over)
with its length and opcodes.  B1's cell loop at 8 queries a thread on
tets, for example: ``python3 tools/sass_loops.py
'whole_table_kernelILi4ELi2ELi8E'``; B5's tet kernel:
``'interp_acc_kernelILi2ELi4E'``.  Static counts: a loop body runs once
per iteration, and code off the common path (a division's slow path)
counts in the total though it rarely runs.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")


def kernels(sass: str):
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump dump."""
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {
        parts[i]: [(int(a, 16), op, rest) for a, op, rest in
                   _INSN.findall(parts[i + 1])]
        for i in range(1, len(parts), 2)
    }


def loops(insns):
    """(start, end, instructions) of every backward branch's body."""
    out = []
    for addr, op, rest in insns:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            out.append((start, addr,
                        [x for x in insns if start <= x[0] <= addr]))
    return out


def top(insns, n):
    c = collections.Counter(op for _, op, _ in insns)
    return ", ".join(f"{op} {k}" for op, k in c.most_common(n))


def main() -> int:
    from interpolate_unstructured_tpu_torch.ops import _kernels

    lib = _kernels.build()
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    pats = [re.compile(p) for p in sys.argv[1:]]
    found = 0
    for name, insns in kernels(sass).items():
        if pats and not any(p.search(name) for p in pats):
            continue
        found += 1
        print(f"{name}: {len(insns)} instructions; {top(insns, 12)}")
        for start, end, body in loops(insns):
            print(f"  loop {start:#x}-{end:#x}: {len(body)} instructions; "
                  f"{top(body, 12)}")
    if not found:
        print("no kernel matches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
