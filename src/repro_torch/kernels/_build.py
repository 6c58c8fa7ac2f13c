"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/kernels/lib<name>-<hash>.so`` under the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, every ``csrc/*.cuh`` header and the flags, so a
changed source rebuilds and an unchanged one loads what is there.  Nothing
builds at import: the first CUDA launch calls ``library(name)``, and
``build_all()`` starts one ``nvcc`` per source together.  A build that
cannot run or fails raises ``RuntimeError`` (never ``ValueError``, which
``ops._with_seed_fallback`` would retry with other constants).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "SIGNATURES", "nvcc_path",
           "library", "load", "swapped", "build_all", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("stream", "hotspot", "pathfinder", "nw", "lud", "matmul",
           "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argtypes of each library's launchers, by function name (pointers and the
#: stream as c_void_p, or ctypes would pass them as 32-bit ints)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "stream": {"stream_launch": [_I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _P]},
    "hotspot": {"hotspot_bands_launch": [_I, _I, _I, _I, _I, _P, _I, _P,
                                         _I, _P, _I, _I, _I, _I, _I, _I, _F,
                                         _F, _F, _F, _I, _P]},
    "pathfinder": {"pathfinder_spans_launch": [
        _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ctypes.c_longlong, _P, _I, _P, _P],
        "pathfinder_blocks": [_I, _I, _I, _I, _P]},
    "nw": {"nw_strips_launch": [_I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I,
                                _I, _I, _P, _P, ctypes.c_longlong, _P, _P]},
    "lud": {"lud_launch": [_I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P],
            "lud_diagonal_launch": [_I, _I, _P, _I, _P, _P],
            "lud_perimeter_row_launch": [_I, _I, _P, _I, _P, _I, _I, _P, _P],
            "lud_perimeter_col_launch": [_I, _I, _P, _I, _P, _I, _I, _P, _P],
            "lud_perimeters_launch": [_I, _I, _P, _I, _P, _I, _I, _P, _I, _I,
                                      _P, _P],
            "lud_internal_launch": [_I, _I, _I, _I, _I, _P, _I, _P, _I, _P,
                                    _I, _I, _I, _I, _I, _P, _P],
            "lud_internal_pair_launch": [_I] * 5 + [_P, _I, _P, _I, _P, _I,
                                                    _I, _I] * 2 +
            [_I, _I, _P, _P],
            "lud_internal_panel_launch": [_I, _I, _I, _I, _P, _I, _P, _I, _P,
                                          _I, _I, _I, _I, _I, _P, _P]},
    "matmul": {"matmul_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                                 _I, _P],
               "matmul_batched_launch": [_I, _I, _I, _I, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _P],
               "matmul_batched_t_launch": [_I, _I, _I, _I, _P, _P, _P, _I,
                                           _I, _I, _I, _I, _P]},
    "flash_attention": {
        name: [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
               _I, _I, _F, _I, _P]
        for name in ("flash_attention_launch", "flash_attention_bf16_launch")
    } | {"flash_mma_rate_launch": [_I, _I, _I, _P, _P]},
    "flash_attention_bwd": {"flash_attention_bwd_launch": [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _I, _F, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest(name: str, csrc: Optional[Path] = None) -> str:
    csrc = csrc or CSRC
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str, csrc: Optional[Path] = None,
            build_dir: Optional[Path] = None) -> Path:
    return (build_dir or BUILD_DIR) / f"lib{name}-{_digest(name, csrc)}.so"


def _start(source: Path, out: Path) -> Tuple[subprocess.Popen, Path]:
    """Start nvcc on ``source``; it writes a temporary file that ``_finish``
    renames to ``out``, so a half-written library never loads."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, out: Path, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None, csrc: Optional[Path] = None,
              build_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Build every missing library of ``csrc`` into ``build_dir`` (this
    checkout's sources and ``BUILD_DIR`` unless given) at once, one
    ``nvcc`` per source, and return each source's library path."""
    names = list(names or SOURCES)
    csrc = csrc or CSRC
    targets = {n: _target(n, csrc, build_dir) for n in names}
    procs = {n: _start(csrc / f"{n}.cu", p) for n, p in targets.items()
             if not p.exists()}
    errors = []
    for n, (proc, tmp) in procs.items():
        try:
            _finish(n, targets[n], proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(path: Path, name: str, missing_ok: bool = False) -> ctypes.CDLL:
    """Load a built library of source ``name`` with its launchers' types;
    ``missing_ok`` passes over launchers the library lacks (another
    checkout's build, whose wrappers here then fail with AttributeError)."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from None
    for fn_name, argtypes in SIGNATURES[name].items():
        if missing_ok and not hasattr(lib, fn_name):
            continue
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = load(build_all([name])[name], name)
        return lib


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL) -> Iterator[None]:
    """Inside the block the wrappers launch ``lib`` (say, another
    checkout's build with the same C interface) for source ``name``."""
    with _lock:
        before = _libs.get(name)
        _libs[name] = lib
    try:
        yield
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``RuntimeError`` for a launcher's non-zero ``cudaError_t``."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: cudaError {rc} ({msg})")
