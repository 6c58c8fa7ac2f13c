"""The SASS of a built kernel library, by kernel function.

``functions(path)`` runs ``cuobjdump -sass`` on one library built by
``kernels._build`` and returns each kernel function's instructions as text,
their addresses and encodings left out, so that two builds of the same
kernel compare equal whatever their names.  It needs the CUDA toolkit's
``cuobjdump``, looked for where ``kernels._build`` looks for ``nvcc``
(``CUDA_HOME/bin``, ``PATH``, ``/usr/local/cuda/bin``), and raises
``RuntimeError`` without it.

    PYTHONPATH=src python -m repro_torch.bench.sass [ROOT] --lib lud \
        --kernel lud_perimeter

builds ROOT's (another checkout's, or this one's) library of that source
into ``ROOT/build/kernels`` and prints the SASS of each kernel function
whose name holds ``--kernel``, one instruction a line, after a count of
its mnemonics.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

__all__ = ["cuobjdump_path", "functions", "main"]

_FUNCTION = re.compile(r"Function : (\S+)")
#: "/*0a40*/  @P0 HGMMA.64x128x16.F32.BF16 gdesc[UR4], RZ, !UPT ;"
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.+?)\s*;")


def cuobjdump_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "cuobjdump"),
                 shutil.which("cuobjdump") or "",
                 "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("cuobjdump not found (CUDA_HOME/bin, PATH or "
                       "/usr/local/cuda/bin)")


def functions(path) -> Dict[str, List[str]]:
    """{mangled kernel name: [instruction text]} of one library."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {path}: {out.stderr.strip()}")
    found: Dict[str, List[str]] = {}
    current = None
    for line in out.stdout.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = found.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append(m.group(1))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="print the SASS of built "
                                 "kernels")
    ap.add_argument("root", nargs="?", type=Path,
                    default=Path(__file__).resolve().parents[3],
                    help="root of the checkout whose sources to build")
    ap.add_argument("--lib", required=True, help="source name, say lud")
    ap.add_argument("--kernel", default="",
                    help="print the functions whose name holds this")
    args = ap.parse_args(argv)
    from ..kernels import _build
    built = _build.build_all([args.lib], args.root / "src" / "repro_torch" /
                             "csrc", args.root / "build" / "kernels")
    for name, instructions in sorted(functions(built[args.lib]).items()):
        if args.kernel not in name:
            continue
        # "@P0 LDG.E.128 ...": the mnemonic follows a predicate
        ops = collections.Counter(i.split()[1 if i.startswith("@") else 0]
                                  for i in instructions)
        print(f"== {name}: {len(instructions)} instructions; " + ", ".join(
            f"{op} {k}" for op, k in sorted(ops.items())))
        for i in instructions:
            print(f"   {i}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
