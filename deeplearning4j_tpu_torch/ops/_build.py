"""Build the package's CUDA kernels with ``nvcc`` at first use and load
them with ``ctypes``.

Each source ``ops/csrc/<name>.cu`` exposes a plain C interface and becomes
its own shared library ``_build/<name>-<hash>.so`` inside the package
directory (listed in ``.gitignore``). The hash covers the source, every
header in ``csrc/`` and the compiler flags, so an edited source rebuilds
and an unchanged one loads what is already there. Nothing here runs at
import time: importing the package needs neither ``nvcc`` nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# sm_90a (not sm_90): the Hopper-only instructions (wgmma, setmaxnreg)
# exist only for the arch-specific target. -Xptxas -v records each
# kernel's registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every kernel source of the package, by name (the file's stem)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on
    PATH, or the toolkit's default install location."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "package's kernels")


def library(name: str) -> Path:
    """Path of the shared library of kernel source ``name`` for the
    current sources and flags (it exists once built)."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(sources()[name].read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each compile took (0.0 for one already built). A failed build
    raises with nvcc's stderr."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise ValueError(f"no kernel source named {unknown} in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {n: 0.0 for n in names}
    for n in names:
        out = library(n)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out, time.perf_counter())
    failures = []
    for n, (p, tmp, out, t0) in procs.items():
        stdout, stderr = p.communicate()
        took[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        if p.returncode != 0:
            failures.append(f"--- {n} (nvcc exit {p.returncode}) ---\n"
                            f"{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return took


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    shared-memory report), or '' when it was built elsewhere."""
    log = library(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library(name)))
            _libs[name] = lib
        return lib
