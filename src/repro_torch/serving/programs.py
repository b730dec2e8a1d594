"""Captured serving programs: the port's counterpart of the engine's
``jax.jit``.

The reference engine compiles each serving round into one XLA program
with fixed shapes (``repro.serving.engine``: the decode step, the paged
co-prefill round, the dense prompt chunk scanned over ``decode_step``)
and donates the KV storage to it.  Here each round is a
:class:`CapturedProgram`: static input tensors, a body that computes the
round from them, and one static output.

On a CUDA device the first :meth:`~CapturedProgram.replay` runs the body
eagerly ``WARMUP_RUNS`` times on a side stream (the kernels' one-time
setup, such as their ``cudaFuncSetAttribute`` calls and the library
builds, and the model's cached constants happen there), then captures it
once into a ``torch.cuda.CUDAGraph`` and replays that graph; every later
call is one replay.  The state the body updates in place (``state``: the
KV storage or the staging stripe) is restored after each warm-up run, so
the first round advances it once, as every later one does: rewriting an
attention K/V entry is idempotent, but a mamba layer's recurrent state
moves a token with every run.  A failed capture raises: there is no eager fallback
and no switch that turns graphs off on the card.  The body's KV storage
and other tensors it closes over are read and written at the addresses
they had at capture, which is why the KV storage and the block table are
never rebound (``kvcache.PagedKVCache.check_storage``).

On the CPU (``device="cpu"``, the tests) the body runs on every call,
without capture, but on the same static inputs and into the same static
output, so an output read after the next call overwrote it, or an input
not copied in, shows up there too.

Kernel launch counters (``kernels._build.counters``) are Python ``+= 1``
in the wrappers, which a replay does not run.  So a program records what
its capture launched (``launches``) and adds that to the counters on every
replay; the warm-up runs and the capture itself count nothing.  On the CPU
the counters are kept the same way (what the body's first run counted,
once per call), though the kernels' plain versions count no launch.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

WARMUP_RUNS = 2              # eager runs before the capture (side stream)


def copy_from_host(dst: torch.Tensor, arr: np.ndarray) -> None:
    """``dst.copy_(arr)`` for a host array of exactly ``dst``'s shape; to
    a CUDA tensor through pinned memory without waiting for the copy
    (PyTorch's pinned allocator keeps the staging buffer until the copy
    has run)."""
    arr = np.ascontiguousarray(arr)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"host array {arr.shape} for a static input "
                         f"{tuple(dst.shape)}")
    host = torch.from_numpy(arr)
    if dst.device.type == "cuda":
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)


class CapturedProgram:
    """One serving round with static inputs and one static output.

    ``inputs`` maps names to the static tensors the body reads (filled by
    :meth:`feed`, or refreshed in place by their owner, as the KV cache's
    block table is); ``body(**inputs)`` returns the round's output tensor.
    ``captures`` counts builds (a graph capture on the card, the first
    run on the CPU), ``replays`` calls, ``capture_s`` the seconds the
    build took (warm-up included) and ``launches`` the kernel launches
    one replay makes, by counter name.  ``state``: the tensors the body
    updates in place, which the warm-up runs before a capture must leave
    as they found them."""

    def __init__(self, name: str, body: Callable[..., torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 state: Sequence[torch.Tensor] = ()):
        self.name = name
        self._body = body
        self.inputs = inputs
        self._state = list(state)
        self.device = next(iter(inputs.values())).device
        self.output: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self._graph = None

    def feed(self, **arrays: np.ndarray) -> None:
        """Copy host arrays into the static inputs of the same names."""
        for name, arr in arrays.items():
            copy_from_host(self.inputs[name], arr)

    def build(self) -> None:
        """Build the program now, without running a round: on the card
        capture it (its warm-up runs leave ``state`` as they found it, and
        a capture runs nothing); on the CPU run the body once with
        ``state`` saved and restored.  A no-op once built."""
        if self.captures:
            return
        if self.device.type == "cuda":
            self._capture()
            return
        saved = [t.clone() for t in self._state]
        t0 = time.perf_counter()
        before = _build.launch_counts()
        out = self._body(**self.inputs)
        self._built(before, out, time.perf_counter() - t0)
        _build.set_launch_counts(before)
        for t, s in zip(self._state, saved):
            t.copy_(s)

    def replay(self) -> torch.Tensor:
        """Run the round on the current static inputs (building the
        program first, on the first call) and return the static output,
        which the next call overwrites."""
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture()
            self._graph.replay()
        else:
            t0 = time.perf_counter()
            before = _build.launch_counts()
            out = self._body(**self.inputs)
            if self.output is None:
                self._built(before, out, time.perf_counter() - t0)
            else:
                self.output.copy_(out)
            _build.set_launch_counts(before)
        for name, n in self.launches.items():
            _build.counters[name].launches += n
        self.replays += 1
        return self.output

    def _built(self, before: Dict[str, int], out: torch.Tensor,
               seconds: float) -> None:
        after = _build.launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        self.output = out
        self.captures += 1
        self.capture_s = seconds

    def _capture(self) -> None:
        t0 = time.perf_counter()
        start = _build.launch_counts()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            saved = [t.clone() for t in self._state]
            for _ in range(WARMUP_RUNS):
                self._body(**self.inputs)
                for t, s in zip(self._state, saved):
                    t.copy_(s)
            del saved
        torch.cuda.current_stream(self.device).wait_stream(side)
        warm = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._body(**self.inputs)
        except RuntimeError as e:
            _build.set_launch_counts(start)
            raise RuntimeError(f"CUDA graph capture of the {self.name!r} "
                               f"program failed: {e}") from e
        self._graph = graph
        self._built(warm, out, time.perf_counter() - t0)
        _build.set_launch_counts(start)
