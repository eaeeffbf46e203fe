#!/usr/bin/env python3
"""Count the SASS instructions of the port's FCM kernels, on a machine
with the CUDA toolkit:

    python3 scripts/sass_census.py [--src DIR] [--source NAME]

Builds every kernel source (of the checkout whose ``src/`` is ``--src``,
or only ``--source``) (`repro_torch.kernels.build`), disassembles
them with ``cuobjdump -sass`` and prints one JSON line per kernel
function: its instruction count and its ``MUFU`` instructions by kind
(``mufu``), and for its largest loop (the span of its longest backward
branch) the instruction count and the count by opcode (``MUFU`` is the
special-function unit: one ``MUFU.LG2`` per ``logf``, one ``MUFU.EX2``
per ``expf``).  The counts are static: an instruction under a predicate
or a branch counts once, whether it runs or not.  ``sha256`` digests
the function's instructions without their addresses, ``loop_sha256``
those of its largest loop: two builds of a kernel with equal digests run
the same machine code.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_FUNC = re.compile(r"^\s*Function : (.+?)\s*$")
_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def _digest(insns) -> str:
    text = "\n".join(_ADDR.sub("", t).strip() for _, _, t in insns)
    return hashlib.sha256(text.encode()).hexdigest()


def census(sass: str) -> list:
    out, name, insns = [], None, []

    def flush():
        if name is None:
            return
        loop = (0, 0)
        for i, (addr, _, text) in enumerate(insns):
            m = _BRA.search(text)
            if m and int(m.group(1), 16) < addr:
                target = int(m.group(1), 16)
                j = next(k for k, (a, _, _) in enumerate(insns) if a >= target)
                if i - j > loop[1] - loop[0]:
                    loop = (j, i)
        body = insns[loop[0]:loop[1] + 1] if loop[1] else []
        ops = collections.Counter(op.split(".")[0] if not op.startswith(
            "MUFU") else op for _, op, _ in body)
        mufu = collections.Counter(op for _, op, _ in insns
                                   if op.startswith("MUFU"))
        out.append({"function": name, "instructions": len(insns),
                    "sha256": _digest(insns),
                    "loop_sha256": _digest(body),
                    "mufu": dict(mufu.most_common()),
                    "loop_instructions": len(body),
                    "loop_ops": dict(ops.most_common())})

    for line in sass.splitlines():
        f = _FUNC.match(line)
        if f:
            flush()
            name, insns = f.group(1), []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            insns.append((int(m.group(1), 16), m.group(2), line))
    flush()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--source", choices=("fcm_accumulate", "fcm_batched",
                                         "fcm_ctiled"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    names = ((args.source,) if args.source else
             ("fcm_accumulate", "fcm_batched", "fcm_ctiled"))
    for name in names:
        build.compile_source(name)
        sass = subprocess.run(
            [str(cuobjdump), "-sass", os.fspath(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
        demangled = subprocess.run(["c++filt"], input=sass, text=True,
                                   capture_output=True).stdout or sass
        for rec in census(demangled):
            print(json.dumps({"source": f"{name}.cu", **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
