"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is one kernel source with a plain C interface (no
PyTorch headers), compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <source>

into ``build/repro_torch_kernels/`` at the repository root (git-ignored) at
first use.  The file name carries a hash of the source, of every
``csrc/*.cuh`` header and of the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  All sources that
need building compile in parallel, one ``nvcc`` process each.  ``ptxas``'s
report (registers, shared memory, spills) is kept per source in
:data:`ptxas_log`.

Binding: every pointer and the CUDA stream are passed as ``c_void_p``
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``), ints as
``c_int``, floats as ``c_float``; each C entry returns ``cudaGetLastError()``
as an int, which the wrappers turn into an exception.

Launch counters: every kernel wrapper that launches is registered with
:func:`counted` and adds one to its ``launches`` each time it launches its
kernel.  :data:`counters` holds them all, so a captured CUDA graph
(``serving/programs.py``), whose replays run no Python, can read what its
capture launched and add that per replay.

The ``meta`` device: every wrapper takes ``meta`` tensors too, for the
dry-run's accounting (``launch/dryrun.py``).  There it launches nothing
and counts no launch: it allocates the kernel's outputs and workspaces as
``meta`` tensors (so a memory count sees them) and adds the work of the
call, from the ``cost`` function beside each kernel, to
:data:`meta_cost`.

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
import types
from pathlib import Path
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}
build_seconds: Optional[float] = None   # wall time of the last nvcc batch
counters: Dict[str, Callable] = {}      # wrapper name -> wrapper (``launches``)


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
    """The library ``src`` builds to, named by a hash of the source, every
    header in ``csrc/`` (any source may include any of them) and the
    flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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


class MetaCost:
    """The work the kernels' ``meta`` routes stood for since the last
    :meth:`reset`: ``flops`` and ``bytes`` in all, and ``by_kernel``
    ``{wrapper: [calls, bytes, flops]}``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.by_kernel: Dict[str, list] = {}

    def add(self, name: str, nbytes: int, flops: int) -> None:
        self.bytes += int(nbytes)
        self.flops += int(flops)
        k = self.by_kernel.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(nbytes)
        k[2] += int(flops)


meta_cost = MetaCost()


def counted(fn: Callable) -> Callable:
    """Register the wrapper ``fn`` as a launch counter: ``fn.launches``
    starts at 0 and is listed in :data:`counters` under ``fn.__name__``."""
    assert fn.__name__ not in counters, fn.__name__
    fn.launches = 0
    counters[fn.__name__] = fn
    return fn


def counter(name: str):
    """Register a launch counter that belongs to no wrapper of its own (a
    wrapper that counts each of its kernel's instantiations apart):
    ``counter(name).launches`` starts at 0, listed under ``name``."""
    return counted(types.SimpleNamespace(__name__=name))


def launch_counts() -> Dict[str, int]:
    """``{wrapper name: launches}`` of every registered counter."""
    return {name: fn.launches for name, fn in counters.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set every counter named in ``counts``."""
    for name, n in counts.items():
        counters[name].launches = n
