"""Build the package's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Each source under ``kernels/csrc/`` compiles with one ``nvcc`` call for
``sm_90a`` into ``build/repro_torch/<stem>-<hash>.so`` at the repository
root (git-ignored).  The hash covers the source bytes and the flags, so an
edited source rebuilds and an unchanged one is reused.  :func:`build`
starts every missing compile at once and waits for all of them.  Nothing
is built when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources) -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{stem: library path}``; raises with nvcc's output on any
    failure.  ptxas's register/spill report lands beside each library as
    ``<lib>.log``."""
    sources = [Path(s) for s in sources]
    out = {s.stem: lib_path(s) for s in sources}
    todo = [s for s in sources if not out[s.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        Path(str(out[s.stem]) + ".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s.name} (rc {p.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[s.stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = build([CSRC / f"{stem}.cu"])[stem]
        lib = _LIBS[stem] = ctypes.CDLL(str(path))
    return lib


def all_sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))
