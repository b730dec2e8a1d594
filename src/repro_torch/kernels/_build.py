"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is one kernel source with a plain C interface (no
PyTorch headers), compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <source>

into ``build/repro_torch_kernels/`` at the repository root (git-ignored) at
first use.  The file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  All sources that
need building compile in parallel, one ``nvcc`` process each.  ``ptxas``'s
report (registers, shared memory, spills) is kept per source in
:data:`ptxas_log`.

Binding: every pointer and the CUDA stream are passed as ``c_void_p``
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``), ints as
``c_int``, floats as ``c_float``; each C entry returns ``cudaGetLastError()``
as an int, which the wrappers turn into an exception.

Nothing here runs at import: the CPU tests import every module of the port on
a machine with no ``nvcc``.
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
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}
build_seconds: Optional[float] = None   # wall time of the last nvcc batch


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH): the port's CUDA "
        "kernels are built on a machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) every source whose library is missing, then
    load every library.  Returns ``{source stem: CDLL}``."""
    global build_seconds
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [(s, _target(s)) for s in sources
                if s.stem not in _libs and not _target(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = []
            for src, so in todo:
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, so, tmp, proc in procs:
                out, _ = proc.communicate()
                ptxas_log[src.stem] = out
                if proc.returncode != 0:
                    failed.append(f"{src.name} (exit {proc.returncode}):\n"
                                  f"{out}")
                    continue
                so.with_suffix(".log").write_text(out)
                os.replace(tmp, so)      # atomic: readers never see half
            build_seconds = time.perf_counter() - t0
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sources:
            if src.stem not in _libs:
                so = _target(src)
                if src.stem not in ptxas_log:
                    log = so.with_suffix(".log")
                    ptxas_log[src.stem] = (log.read_text()
                                           if log.exists() else "")
                _libs[src.stem] = ctypes.CDLL(str(so))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    missing library first)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
