"""The SASS of a built kernel library, by kernel function.

``functions(path)`` runs ``cuobjdump -sass`` on one library built by
``kernels._build`` and returns each kernel function's instructions as text,
their addresses and encodings left out, so that two builds of the same
kernel compare equal whatever their names.  It needs the CUDA toolkit's
``cuobjdump``, looked for where ``kernels._build`` looks for ``nvcc``
(``CUDA_HOME/bin``, ``PATH``, ``/usr/local/cuda/bin``), and raises
``RuntimeError`` without it.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List

__all__ = ["cuobjdump_path", "functions"]

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
