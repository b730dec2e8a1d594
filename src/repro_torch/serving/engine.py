"""Batched serving engine: slot-granular prefill/decode primitives.

Counterpart of ``repro.serving.engine`` in paged mode.  The engine owns
the pooled KV (a :class:`~repro_torch.serving.kvcache.PagedKVCache` over
``max_slots`` sequences) and exposes the primitives the scheduler drives:

* ``begin_prefill`` / ``advance_prefill`` / ``cancel_prefill`` — the
  resumable co-prefill.  ``begin_prefill`` claims slots (and loads cached
  prefix blocks) and registers one :class:`PrefillCursor` per prompt;
  ``advance_prefill`` runs ``(prefill_batch, prefill_chunk)`` chunk rounds
  FIFO under a token budget (executed token positions), each round's K/V
  written straight into the rows' pool blocks and attended through the
  CUDA paged-prefill kernel; unfinished cursors stay parked between
  scheduler steps.  ``prefill_into_slots`` / ``prefill_into_slot`` run a
  batch to completion.
* ``decode_once`` — one token for every slot against the pooled KV
  through the paged-decode kernel; mid-prefill slots' table rows are
  masked to the trash block.  Logits stay **on the device** until
  ``sample_tokens``, the one host sync of a step.

PyTorch runs eagerly: the reference's jitted, buffer-donating step
programs become plain calls that update the KV storage in place.
Sampling is per row: greedy rows take the lowest token id within
``greedy_tie_eps`` of the max (exactly the reference's rule); other rows
sample with the Gumbel-max trick from a ``torch.Generator`` seeded with
``rng_seed`` — their streams are not the reference's ``jax.random`` ones.

Telemetry matches the reference: ``prefill_tokens`` (real prompt
tokens), ``prefill_tokens_executed`` (every position a round ran, padding
included), ``prefill_tokens_padding``, ``cached_prefix_tokens``,
``decode_steps`` and ``transient_prefill_bytes`` (always 0: paged prefill
never stages a dense stripe).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.serving.kvcache import PagedKVCache


@dataclass
class SamplingParams:
    temperature: float = 1.0
    greedy: bool = False
    max_new_tokens: int = 32
    eos_token: Optional[int] = None      # early-exit on this token id


@dataclass
class Request:
    prompt: np.ndarray                       # (prompt_len,) int32
    params: SamplingParams = field(default_factory=SamplingParams)
    # enc-dec frame embeddings: unused by the dense decoders of this slice
    encoder_input: Optional[np.ndarray] = None
    # SLO tenant label: threaded submit -> scheduler -> metrics
    tenant: str = "default"


@dataclass
class PrefillCursor:
    """Progress of one in-flight (resumable) prefill.

    ``tokens`` is the full target sequence, ``start_pos`` the prefix-cache
    resume offset, and ``pos`` the next position to execute:
    ``start_pos <= pos <= len(tokens)``.  ``seq`` is the begin-order stamp
    rounds are scheduled by (FIFO).  ``last_logits`` is set (on the
    device) once the row's last real token has run."""
    slot: int
    tokens: np.ndarray
    start_pos: int
    pos: int
    seq: int = 0
    encoder_input: Optional[np.ndarray] = None
    prefix_blocks: Tuple[int, ...] = ()
    last_logits: object = None

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.pos

    @property
    def done(self) -> bool:
        return self.pos >= len(self.tokens)


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA request on a machine without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch kernels")
    return dev


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Fixed-slot batched engine (continuous batching over ``max_slots``)
    over paged KV.

    ``prefix_cache_blocks > 0`` turns on the prefix cache: the KV cache
    grows a prefix store of that many blocks and ``self.prefix_cache``
    holds the radix index the scheduler probes at admission.
    ``num_blocks`` sizes the KV pool (default: worst case); below
    ``max_slots * ceil(max_seq_len / block_size)`` ``OutOfBlocks`` becomes
    a real event the scheduler handles by deferring admissions and
    preempting decode.  ``paged=False`` (the dense per-slot layout) is
    ported with the dense-mode slice and raises here.

    ``device`` defaults to ``"cuda"``: on a machine without a card the
    constructor raises; the CPU runs only when asked (``device="cpu"``),
    and then the paged kernels run as their plain PyTorch versions.
    """

    def __init__(self, cfg, params, max_seq_len: int, max_slots: int = 8,
                 rng_seed: int = 0, kv_block_size: int = 16,
                 prefix_cache_blocks: int = 0, prefill_chunk: int = 16,
                 paged: bool = True, num_blocks: Optional[int] = None,
                 prefill_batch: int = 4, greedy_tie_eps: float = 1e-2,
                 device="cuda"):
        if not paged:
            raise NotImplementedError(
                "dense-mode serving (paged=False) is ported with the "
                "dense-mode slice; use paged=True")
        T._check_family(cfg)
        self.device = resolve_device(device)
        # numerics as the reference's: f32 matmuls in full f32 (no TF32),
        # bf16 matmuls with full-precision reductions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_seq_len = max_seq_len
        self.max_slots = max_slots
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self.prefill_chunk = prefill_chunk
        # > 0 makes greedy argmax layout-deterministic: any token whose
        # logit is within eps of the max is eligible and the LOWEST id
        # wins; 0.0 is raw argmax
        self.greedy_tie_eps = float(greedy_tie_eps)
        # rows per paged-prefill round (co-admission width)
        self.prefill_batch = max(1, min(prefill_batch, max_slots))
        self.paged = True
        self.kv = PagedKVCache(
            cfg, max_slots, max_seq_len, block_size=kv_block_size,
            prefix_blocks=prefix_cache_blocks, num_blocks=num_blocks,
            device=self.device)
        self.prefix_cache = None
        if self.kv.prefix_pool is not None:
            from repro_torch.serving.prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(self.kv)
        self.decode_steps = 0                # accounting (tested)
        self.prefill_tokens = 0              # real tokens run through prefill
        self.prefill_tokens_executed = 0     # incl. padding (FLOPs proxy)
        self.prefill_tokens_padding = 0      # executed - real
        self.cached_prefix_tokens = 0        # tokens served from the store
        self.transient_prefill_bytes = 0     # paged: never a staging stripe
        # bound by the scheduler that drives this engine (one tracer per
        # replica); None until then
        self.tracer = None
        # deterministic fault-injection hook, bound by the scheduler
        self.fault_injector = None
        # shape-signature telemetry (serving/profiling.py)
        from repro_torch.serving.profiling import RecompilationTracker
        self.recompiles = RecompilationTracker()
        self._inflight: Dict[int, PrefillCursor] = {}   # slot -> cursor
        self._begin_seq = 0                  # FIFO stamp for cursors

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- scheduler-facing primitives ----------------------------------------

    def prefill_into_slot(self, prompt: np.ndarray,
                          encoder_input: Optional[np.ndarray] = None,
                          *, start_pos: int = 0,
                          prefix_blocks: Sequence[int] = (),
                          ) -> Tuple[int, np.ndarray]:
        """Prefill one prompt into a free slot; ``start_pos > 0`` resumes
        from cached ``prefix_blocks``.  Returns ``(slot, last_logits (V,))``."""
        [(slot, last)] = self.prefill_into_slots(
            [prompt], [encoder_input], start_pos=[start_pos],
            prefix_blocks=[list(prefix_blocks)])
        return slot, last

    def prefill_into_slots(self, prompts: Sequence[np.ndarray],
                           encoder_inputs: Optional[Sequence] = None,
                           *, start_pos: Optional[Sequence[int]] = None,
                           prefix_blocks: Optional[Sequence] = None,
                           ) -> List[Tuple[int, np.ndarray]]:
        """Co-prefill a batch of prompts into free slots, to completion
        (one ``begin_prefill`` + one unbudgeted ``advance_prefill``).
        All-or-nothing on error.  Returns ``[(slot, last_logits (V,))]``
        in input order."""
        cursors = self.begin_prefill(prompts, encoder_inputs,
                                     start_pos=start_pos,
                                     prefix_blocks=prefix_blocks)
        self.advance_prefill(cursors)        # cleans up all slots on error
        # one host-transfer pass AFTER every round dispatched
        return [(c.slot, c.last_logits.float().cpu().numpy())
                for c in cursors]

    def begin_prefill(self, prompts: Sequence[np.ndarray],
                      encoder_inputs: Optional[Sequence] = None,
                      *, start_pos: Optional[Sequence[int]] = None,
                      prefix_blocks: Optional[Sequence] = None,
                      ) -> List[PrefillCursor]:
        """Claim slots for a batch of prompts, load their cached prefix
        blocks, and register one in-flight :class:`PrefillCursor` per row.
        Slot allocation is all-or-nothing: on ``OutOfBlocks`` every slot
        claimed so far is released before the error propagates."""
        n = len(prompts)
        prompts = [np.asarray(p, np.int32) for p in prompts]
        encoder_inputs = encoder_inputs or [None] * n
        start_pos = list(start_pos) if start_pos is not None else [0] * n
        prefix_blocks = (list(prefix_blocks) if prefix_blocks is not None
                         else [()] * n)
        for p, sp in zip(prompts, start_pos):
            assert 0 <= sp < len(p), (sp, len(p))
        cursors: List[PrefillCursor] = []
        try:
            for p, e, sp, pb in zip(prompts, encoder_inputs, start_pos,
                                    prefix_blocks):
                slot = self.kv.alloc_slot(len(p))
                cur = PrefillCursor(slot=slot, tokens=p, start_pos=sp,
                                    pos=sp, seq=self._begin_seq,
                                    encoder_input=e,
                                    prefix_blocks=tuple(pb))
                self._begin_seq += 1
                cursors.append(cur)
                if sp:
                    self.kv.load_prefix_blocks_paged(slot, pb)
        except Exception:
            for cur in cursors:              # all-or-nothing
                self.kv.free_slot(cur.slot)
            raise
        for cur in cursors:
            self._inflight[cur.slot] = cur
        self.cached_prefix_tokens += sum(start_pos)
        return cursors

    def advance_prefill(self, cursors: Optional[Sequence[PrefillCursor]]
                        = None, token_budget: Optional[int] = None,
                        ) -> List[PrefillCursor]:
        """Run chunk rounds against in-flight prefills (``cursors``
        defaults to every cursor on the engine) until all complete or
        ``token_budget`` *executed* token positions have run (a round
        costs ``prefill_batch * prefill_chunk``).  The first round always
        runs; rounds are FIFO by begin order.

        Returns the cursors that **completed during this call**, each
        with on-device ``last_logits``; unfinished cursors stay parked.
        On any error every cursor this call touched has its slot released
        before the error propagates."""
        working = [c for c in (cursors if cursors is not None
                               else list(self._inflight.values()))
                   if not c.done]
        for c in working:
            assert self._inflight.get(c.slot) is c, \
                f"cursor for slot {c.slot} is not in flight"
        involved = list(working)
        finished: List[PrefillCursor] = []
        spent = 0
        C = self.prefill_chunk
        Bp = self.prefill_batch
        tr = self.tracer

        def budget_left():
            return (token_budget is None or spent < token_budget
                    or spent == 0)

        try:
            # fault hook INSIDE the all-or-nothing block: an injected
            # prefill fault takes the same slot-release path a real
            # engine error does
            if self.fault_injector is not None:
                self.fault_injector.on_engine_op("prefill")
            working.sort(key=lambda c: c.seq)    # FIFO by begin order
            while working and budget_left():
                sel = working[:Bp]
                tables = np.full((Bp, self.kv.blocks_per_slot),
                                 self.kv.trash_block, np.int32)
                toks = np.zeros((Bp, C), np.int32)
                starts = np.zeros(Bp, np.int32)
                qlens = np.zeros(Bp, np.int32)
                for r, cur in enumerate(sel):
                    tables[r] = self.kv.table_row(cur.slot)
                    ql = min(cur.remaining, C)
                    toks[r, :ql] = cur.tokens[cur.pos:cur.pos + ql]
                    starts[r] = cur.pos
                    qlens[r] = ql
                self.recompiles.observe(
                    "prefill_paged", (toks.shape, tables.shape), tracer=tr)
                batch = {"tokens": self._upload(toks),
                         "positions": self._upload(starts),
                         "q_lens": self._upload(qlens),
                         "cache": self.kv.cache,
                         "block_tables": self._upload(tables)}
                # writes the round's K/V into the pool storage in place
                # (the reference donates the cache to its jitted program)
                logits, _ = T.prefill_step(self.params, self.cfg, batch)
                real = int(qlens.sum())
                # FLOPs proxy: every row of the (Bp, C) round executes,
                # dummy rows included
                spent += Bp * C
                self.prefill_tokens += real
                self.prefill_tokens_executed += Bp * C
                self.prefill_tokens_padding += Bp * C - real
                for r, cur in enumerate(sel):
                    cur.pos += int(qlens[r])
                    if tr is not None and tr.enabled and qlens[r]:
                        tr.prefill_advance(cur.slot, int(qlens[r]),
                                           cur.pos, len(cur.tokens))
                    if cur.done:
                        # on-device slice: no host sync inside the round
                        # loop, so rounds keep dispatching
                        cur.last_logits = logits[r, int(qlens[r]) - 1]
                        finished.append(cur)
                working = [c for c in working if not c.done]
        except Exception:
            # all-or-nothing per call: release every slot this call
            # touched, so one failed round can never leak slots or blocks
            for cur in involved:
                self._inflight.pop(cur.slot, None)
                self.kv.free_slot(cur.slot)
            raise
        for cur in finished:
            del self._inflight[cur.slot]
        return finished

    def cancel_prefill(self, slot: int) -> None:
        """Abandon an in-flight prefill (mid-prefill preemption): the
        cursor is dropped and the slot and its KV blocks return to the
        pool.  The caller re-queues the request."""
        self._inflight.pop(slot)
        self.kv.free_slot(slot)

    @property
    def inflight_prefill_tokens(self) -> int:
        """Real token positions still to execute across in-flight
        cursors (telemetry; the scheduler's budget debt)."""
        return sum(c.remaining for c in self._inflight.values())

    def decode_once(self, tokens: np.ndarray,
                    positions: np.ndarray) -> torch.Tensor:
        """One decode step over all slots.  ``tokens``/``positions`` are
        (max_slots,); rows of free slots carry dummies that land in the
        trash block.  Returns logits (max_slots, V) **on the device** —
        pass them straight to ``sample_tokens``."""
        if self.fault_injector is not None:
            # before any state mutation: a decode-site fault leaves the
            # cache untouched, so the scheduler can retry the same step
            self.fault_injector.on_engine_op("decode")
        # free slots' rows point at the trash block; a mid-prefill slot's
        # table maps real blocks already, so its row is masked to the
        # trash block too — its dummy decode write at position 0 must not
        # corrupt KV the prefill just produced
        batch = {"tokens": self._upload(np.asarray(tokens, np.int32)[:, None]),
                 "positions": self._upload(np.asarray(positions, np.int32)),
                 "cache": self.kv.cache,
                 "block_tables": self.kv.device_block_tables(
                     mask_slots=self._inflight)}
        self.recompiles.observe(
            "decode_step", (np.shape(tokens), np.shape(positions)),
            tracer=self.tracer)
        # updates self.kv.cache in place (the reference donates it)
        logits, _ = T.decode_step(self.params, self.cfg, batch)
        self.decode_steps += 1
        return logits[:, 0]                  # on device; no sync here

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                greedy: np.ndarray) -> torch.Tensor:
        # temperatures below epsilon ARE greedy (dividing by a tiny clamp
        # overflows), as in the reference
        greedy = np.asarray(greedy, bool) | (np.asarray(temps) < 1e-4)
        logits = logits.float()
        if self.greedy_tie_eps > 0.0:
            # deterministic tie break: lowest token id within eps of the
            # max.  torch.argmax returns the FIRST maximal index, so the
            # argmax of the eligibility mask is the lowest eligible id
            amax = logits.max(dim=-1, keepdim=True).values
            g_tok = torch.argmax(
                (logits >= amax - self.greedy_tie_eps).to(torch.uint8),
                dim=-1)
        else:
            g_tok = torch.argmax(logits, dim=-1)
        if greedy.all():
            return g_tok
        safe_t = self._upload(np.where(greedy, 1.0, temps).astype(np.float32))
        u = torch.rand(logits.shape, generator=self.generator,
                       device=self.device).clamp_(min=1e-20)
        cat = torch.argmax(logits / safe_t[:, None] - torch.log(-torch.log(u)),
                           dim=-1)                       # Gumbel-max
        return torch.where(self._upload(greedy), g_tok, cat)

    def sample_tokens(self, logits: torch.Tensor, temps: np.ndarray,
                      greedy: np.ndarray) -> np.ndarray:
        """Per-row sampling: row i uses temps[i] / greedy[i].  Rows whose
        temperature is below 1e-4 (including exactly 0.0) sample greedily."""
        self.recompiles.observe("sample", tuple(logits.shape),
                                tracer=self.tracer)
        # deliberate: THE one host sync per step — the scheduler needs
        # concrete token ids for EOS/retirement bookkeeping
        return np.asarray(self._sample(  # repro-lint: disable=RL001
            logits, temps, greedy).cpu())

    def free_slot(self, slot: int) -> None:
        self.kv.free_slot(slot)

    # -- compatibility wrapper ----------------------------------------------

    def generate(self, requests: List[Request]) -> List[np.ndarray]:
        """Serve a batch of requests through the scheduler path and return
        generated tokens in submission order."""
        from repro_torch.serving.scheduler import Scheduler
        sched = Scheduler(self)
        rids = [sched.submit(r) for r in requests]
        sched.run()
        return [sched.output(rid) for rid in rids]
