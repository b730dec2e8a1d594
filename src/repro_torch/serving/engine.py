"""Batched serving engine: slot-granular prefill/decode primitives.

Counterpart of ``repro.serving.engine``.  The engine owns the pooled KV
(a :class:`~repro_torch.serving.kvcache.PagedKVCache` over ``max_slots``
sequences, dense per-slot stripes by default or paged blocks with
``paged=True``) and exposes the primitives the scheduler drives:

* ``begin_prefill`` / ``advance_prefill`` / ``cancel_prefill`` — the
  resumable co-prefill.  ``begin_prefill`` claims slots and registers one
  :class:`PrefillCursor` per prompt; ``advance_prefill`` runs chunk rounds
  FIFO under a token budget (executed token positions); unfinished
  cursors stay parked between scheduler steps.  Paged: each round is a
  ``(prefill_batch, prefill_chunk)`` tile whose K/V go straight into the
  rows' pool blocks through the CUDA paged-prefill kernel, and cached
  prefix blocks load block to block at ``begin_prefill``.  Dense: each
  chunk of ``prefill_chunk`` tokens (padding included) is replayed one
  token at a time through ``decode_step`` at batch 1 into the engine's
  one batch-1 staging stripe (zeroed at the cursor's first chunk, with
  the cached prefix loaded), which ``write_prefill`` copies into the slot
  when done; a cursor left mid-prompt while another claims the stripe is
  parked in a copy of it and copied back when it resumes.
  ``prefill_into_slots`` / ``prefill_into_slot`` run a batch to
  completion.
* ``decode_once`` — one token for every slot against the pooled KV.
  Paged: through the paged-decode kernel, with mid-prefill slots' table
  rows masked to the trash block.  Dense: each row writes its own stripe
  (a free or mid-prefill slot's dummy write lands where its next prefill
  overwrites it) and attends it, through the int8 flash kernel for the
  int8 cache.  Logits stay **on the device** until ``sample_tokens``, the
  one host sync of a step.

The moe family (qwen3-moe, dbrx) serves as the dense decoders do, paged
or dense.  Every row of a round runs the MoE block and takes expert
capacity, so each round feeds the reference's token ids and positions in
every row: token 0 past a prompt's end in a paged tile or a dense chunk,
``q_len = 0`` rows of a paged tile, idle slots' dummies in decode.

The ssm (mamba2) and hybrid (zamba2) families serve in dense mode only,
as in the reference: their cache holds each mamba layer's recurrent
state (no token-position axis), so the KV cache refuses paged mode and
the engine asks it for no prefix store (``prefix_cache`` stays ``None``
whatever ``prefix_cache_blocks`` says).  A dense chunk's padding tokens
past a prompt's end run through ``decode_step`` like its real ones, so
they advance that state too, exactly as the reference's scanned chunk
does; a cursor parked mid-prompt keeps the whole state in its copy.

The encdec family (whisper) serves in dense mode only, as in the
reference: its decoder's K/V depend on the encoder's frames as well as on
the tokens, so the KV cache refuses paged mode and the prefix store.
Each request's frames (``Request.encoder_input``, (encoder_seq, d)) run
through the encoder once, at admission (``begin_prefill``), eagerly: the
encoder runs once a request outside the rounds, on frames uploaded from
host memory, which a capture may not read, and a program of its own would
add a capture and a staging buffer for a step that is already one
batched launch a layer.  Its output is copied in place into the slot's
row of the encoder pool (``_enc_pool``, (max_slots, encoder_seq, d)),
which every decode round reads whole; each dense prompt chunk reads the
slot's row from the batch-1 staging buffer ``_enc1``, refreshed in place
before the chunk.  Both stay at their addresses, so the captured rounds
read them in place.

Each round is one program (``serving/programs.py``), as each is one
jitted program in the reference: ``decode_step`` (``(max_slots,)`` rows,
in paged mode with the ``(max_slots, blocks_per_slot)`` table), the paged
co-prefill round ``prefill_paged`` (a ``(prefill_batch, prefill_chunk)``
tile) and the dense prompt chunk ``prefill_chunk`` (``prefill_chunk``
``decode_step``s at batch 1).  The engine holds two: decode and its
mode's prefill.  On the card each is captured once into a CUDA graph at
its first round and replayed on every later one; on the CPU the same
body runs on the same static buffers.  The KV storage is updated in
place, as the reference donates it.  A program's output is overwritten
by its next round, so the prefill rounds clone each finished row's last
logits and the scheduler samples a decode round's logits before the
next.  A program's build is its compile for ``recompiles``.

Under the span recorder (``core/spans.py``) each paged or dense prefill
round is the spans ``serve.prefill.build`` (its tile arrays, the
recompile check), ``serve.prefill.feed`` (the input copies) and
``serve.prefill.replay`` (the storage check, the replay, the logit
clones), and a decode round ``serve.decode.feed`` (the copies, the block
table refresh, the recompile and storage checks) and
``serve.decode.replay``; the copies, each replay (its CUDA events around
``prog.replay()``, never in the program) and the clones are device units.

Sampling runs eagerly (the reference's separate ``_sample_vec``
program), per row: greedy rows take the lowest token id within
``greedy_tie_eps`` of the max (exactly the reference's rule); other rows
sample with the Gumbel-max trick from a ``torch.Generator`` seeded with
``rng_seed`` — their streams are not the reference's ``jax.random`` ones.

Telemetry matches the reference: ``prefill_tokens`` (real prompt
tokens), ``prefill_tokens_executed`` (every position a round ran, padding
included), ``prefill_tokens_padding``, ``cached_prefix_tokens``,
``decode_steps`` and ``transient_prefill_bytes`` (the batch-1 staging
stripe's bytes once a dense prefill ran; 0 in paged mode, which stages
none).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spans import SPANS
from repro_torch.models import transformer as T
from repro_torch.serving.kvcache import PagedKVCache, _leaves
from repro_torch.serving.programs import CapturedProgram


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
    # encdec frame embeddings (encoder_seq, d_model); decoders take none
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
    dense_cache: object = None               # dense progress, parked

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


def make_serve_step(cfg, *, long_context: bool = False):
    """``serve_step(params, batch) -> (logits, cache)``: one token per
    row, ``transformer.decode_step`` (batch: tokens (B, 1), positions
    (B,), cache, and encoder_output / mrope_positions where the family
    takes them; the cache is written in place)."""
    def serve_step(params, batch):
        return T.decode_step(params, cfg, batch, long_context=long_context)
    return serve_step


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Fixed-slot batched engine (continuous batching over ``max_slots``).

    ``prefix_cache_blocks > 0`` turns on the prefix cache: the KV cache
    grows a prefix store of that many blocks and ``self.prefix_cache``
    holds the radix index the scheduler probes at admission.
    ``num_blocks`` sizes the KV pool (default: worst case); below
    ``max_slots * ceil(max_seq_len / block_size)`` ``OutOfBlocks`` becomes
    a real event the scheduler handles by deferring admissions and
    preempting decode.  ``paged=False`` (the default, as the reference's)
    keeps one worst-case stripe per slot; it is the layout that takes
    ``cfg.kv_cache_dtype == "int8"``.

    ``device`` defaults to ``"cuda"``: on a machine without a card the
    constructor raises; the CPU runs only when asked (``device="cpu"``),
    and then the kernels run as their plain PyTorch versions.
    """

    def __init__(self, cfg, params, max_seq_len: int, max_slots: int = 8,
                 rng_seed: int = 0, kv_block_size: int = 16,
                 prefix_cache_blocks: int = 0, prefill_chunk: int = 16,
                 paged: bool = False, num_blocks: Optional[int] = None,
                 prefill_batch: int = 4, greedy_tie_eps: float = 1e-2,
                 device="cuda"):
        T._check_family(cfg, T._FAMILIES)
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
        # rows per paged-prefill round (co-admission width); dense mode
        # prefills serially whatever the batch size
        self.prefill_batch = max(1, min(prefill_batch, max_slots))
        self.paged = paged
        # a family whose cache is not positional keeps no prefix store:
        # recurrent state depends on every token before, not one block's,
        # and encdec's K/V on the frames too
        self.kv = PagedKVCache(
            cfg, max_slots, max_seq_len, block_size=kv_block_size,
            prefix_blocks=(prefix_cache_blocks
                           if T.positional_cache(cfg) else 0),
            num_blocks=num_blocks, paged=paged, device=self.device)
        self.prefix_cache = None
        if self.kv.prefix_pool is not None:
            from repro_torch.serving.prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(self.kv)
        self.decode_steps = 0                # accounting (tested)
        self.prefill_tokens = 0              # real tokens run through prefill
        self.prefill_tokens_executed = 0     # incl. padding (FLOPs proxy)
        self.prefill_tokens_padding = 0      # executed - real
        self.cached_prefix_tokens = 0        # tokens served from the store
        self.transient_prefill_bytes = 0     # peak batch-1 staging cache
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
        # the round programs, built at their first round (decode and the
        # mode's prefill: two per engine)
        self.programs: Dict[str, CapturedProgram] = {}
        # dense mode: the batch-1 staging stripe and the cursor it holds
        self._stripe = None
        self._stripe_owner: Optional[PrefillCursor] = None
        # encdec: each slot's encoder output, and the batch-1 row a dense
        # prompt chunk reads; both read by the captured rounds in place
        self._enc_pool = self._enc1 = None
        if cfg.family == "encdec":
            shape = (cfg.encoder_seq, cfg.d_model)
            dt = getattr(torch, cfg.dtype)
            self._enc_pool = torch.zeros((max_slots,) + shape, dtype=dt,
                                         device=self.device)
            self._enc1 = torch.zeros((1,) + shape, dtype=dt,
                                     device=self.device)

    @torch.no_grad()
    def _encode_into_slot(self, slot: int, frames) -> None:
        """Run the encoder over one request's frames (encoder_seq, d) and
        copy its output into the slot's row of the encoder pool, in
        place."""
        if frames is None:
            raise ValueError(f"family {self.cfg.family!r} needs each "
                             "request's encoder_input (its frames)")
        x = torch.as_tensor(np.asarray(frames, np.float32)).to(self.device)
        self._enc_pool[slot].copy_(
            T._encode(self.params["encoder"], self.cfg, x[None])[0])

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- the round programs --------------------------------------------------

    def _zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _program(self, name: str) -> CapturedProgram:
        """The engine's program ``name``, made at its first round.  Its
        body closes over the weights and the KV storage (or the dense
        staging stripe), which stay at their addresses; their leaves are
        the program's in-place ``state``."""
        prog = self.programs.get(name)
        if prog is not None:
            return prog
        params, cfg, cache = self.params, self.cfg, self.kv.cache
        S, Bp, C = self.max_slots, self.prefill_batch, self.prefill_chunk
        if name == "decode_step":
            inputs = {"tokens": self._zeros(S, 1),
                      "positions": self._zeros(S)}
            if self.paged:
                inputs["block_tables"] = self.kv.block_tables_dev

            extra = ({} if self._enc_pool is None
                     else {"encoder_output": self._enc_pool})

            def body(**batch):
                return T.decode_step(params, cfg,
                                     dict(batch, cache=cache, **extra))[0]
        elif name == "prefill_paged":
            inputs = {"tokens": self._zeros(Bp, C),
                      "positions": self._zeros(Bp),
                      "q_lens": self._zeros(Bp),
                      "block_tables": self._zeros(
                          Bp, self.kv.blocks_per_slot)}

            def body(**batch):
                return T.prefill_step(params, cfg,
                                      dict(batch, cache=cache))[0]
        else:
            assert name == "prefill_chunk", name
            inputs = {"tokens": self._zeros(C, 1),
                      "positions": self._zeros(C)}
            cache = self._stripe
            extra = ({} if self._enc1 is None
                     else {"encoder_output": self._enc1})

            def body(tokens, positions):
                # the reference's scanned chunk: C decode steps at batch 1
                return torch.stack([T.decode_step(params, cfg, {
                    "tokens": tokens[t:t + 1],
                    "positions": positions[t:t + 1],
                    "cache": cache, **extra})[0][0, 0] for t in range(C)])
        # what the body updates in place: the KV storage, or the stripe
        prog = self.programs[name] = CapturedProgram(
            name, body, inputs, state=[t for _, t in _leaves(cache)])
        return prog

    def warm_up(self) -> None:
        """Build the engine's two round programs (decode and the mode's
        prefill) before its first round, without running a round: on the
        card each is captured now (``CapturedProgram.build``), so no round
        of a served request pays a capture.  The cache is left as it was.
        A fabric worker calls this before its first heartbeat."""
        if not self.paged and self._stripe is None:
            self._stripe = T.init_cache(self.cfg, 1, self.max_seq_len,
                                        device=self.device)
        for name in ("decode_step",
                     "prefill_paged" if self.paged else "prefill_chunk"):
            self._program(name).build()

    def _replay(self, prog: CapturedProgram) -> torch.Tensor:
        self.kv.check_storage()
        return SPANS.replay(prog)

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
                # dense mode loads the prefix into the staging cache made
                # at the cursor's first chunk, so co-admitted prompts that
                # wait their FIFO turn hold no stripe yet
                if sp and self.paged:
                    self.kv.load_prefix_blocks_paged(slot, pb)
                if self._enc_pool is not None:
                    self._encode_into_slot(slot, e)
        except Exception:
            for cur in cursors:              # all-or-nothing
                self.kv.free_slot(cur.slot)
            raise
        for cur in cursors:
            self._inflight[cur.slot] = cur
        self.cached_prefix_tokens += sum(start_pos)
        return cursors

    def _claim_stripe(self, cur: PrefillCursor) -> None:
        """Put ``cur``'s dense prefill state in the batch-1 staging stripe
        (dense mode only; the stripe is made once, at the first chunk).
        The cursor the stripe held, if still mid-prompt, is parked in a
        copy first; ``cur`` either comes back from its parked copy or
        starts on a zeroed stripe with its cached prefix loaded."""
        if self._stripe is None:
            self._stripe = T.init_cache(self.cfg, 1, self.max_seq_len,
                                        device=self.device)
        owner, stripe = self._stripe_owner, self._stripe
        if owner is cur:
            return
        if (owner is not None and not owner.done
                and self._inflight.get(owner.slot) is owner):
            owner.dense_cache = [t.clone() for _, t in _leaves(stripe)]
        if cur.dense_cache is not None:
            for (_, t), parked in zip(_leaves(stripe), cur.dense_cache):
                t.copy_(parked)
            cur.dense_cache = None
        else:
            for _, t in _leaves(stripe):
                t.zero_()
            self.transient_prefill_bytes = max(
                self.transient_prefill_bytes,
                sum(t.numel() * t.element_size() for _, t in _leaves(stripe)))
            if cur.start_pos:
                self.kv.load_prefix_blocks(stripe, cur.prefix_blocks)
        self._stripe_owner = cur

    def _dense_chunk(self, cur: PrefillCursor) -> None:
        """One dense prefill chunk: ``prefill_chunk`` tokens from
        ``cur.pos`` (zero-padded past the prompt) replayed one at a time
        through ``decode_step`` at batch 1 into the staging stripe, in one
        program, as the reference's scanned chunk program does.  Sets
        ``last_logits`` (on the device, cloned from the program's (C, V)
        output) when the prompt's last token runs in this chunk."""
        dev = self.device
        with SPANS.span("serve.prefill.build"):
            with SPANS.unit("stripe", dev):
                self._claim_stripe(cur)
                if self._enc1 is not None:
                    self._enc1.copy_(self._enc_pool[cur.slot:cur.slot + 1])
            C = self.prefill_chunk
            ql = min(cur.remaining, C)
            chunk = np.zeros((C, 1), np.int32)
            chunk[:ql, 0] = cur.tokens[cur.pos:cur.pos + ql]
            self.recompiles.observe("prefill_chunk", (1, C),
                                    tracer=self.tracer)
            prog = self._program("prefill_chunk")
        with SPANS.span("serve.prefill.feed"), SPANS.unit("feed", dev):
            prog.feed(tokens=chunk, positions=np.arange(
                cur.pos, cur.pos + C, dtype=np.int32))
        with SPANS.span("serve.prefill.replay"):
            logits = self._replay(prog)
            li = (len(cur.tokens) - 1) - cur.pos    # last real token's step
            if li < C:
                with SPANS.unit("clone", dev):
                    cur.last_logits = logits[li].clone()
        cur.pos += ql
        self.prefill_tokens += ql
        self.prefill_tokens_executed += C
        self.prefill_tokens_padding += C - ql
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.prefill_advance(cur.slot, ql, cur.pos, len(cur.tokens))

    def advance_prefill(self, cursors: Optional[Sequence[PrefillCursor]]
                        = None, token_budget: Optional[int] = None,
                        ) -> List[PrefillCursor]:
        """Run chunk rounds against in-flight prefills (``cursors``
        defaults to every cursor on the engine) until all complete or
        ``token_budget`` *executed* token positions have run (a paged
        round costs ``prefill_batch * prefill_chunk``, a dense chunk
        ``prefill_chunk``).  The first round always runs; rounds are FIFO
        by begin order.

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
        dev = self.device

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
            if not self.paged:
                for cur in working:
                    while not cur.done and budget_left():
                        self._dense_chunk(cur)
                        spent += C
                    if cur.done:
                        with SPANS.unit("write_prefill", dev):
                            self.kv.write_prefill(cur.slot, self._stripe)
                        self._stripe_owner = None
                        finished.append(cur)
                    if not budget_left():
                        break
            else:
                while working and budget_left():
                    with SPANS.span("serve.prefill.build"):
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
                            "prefill_paged", (toks.shape, tables.shape),
                            tracer=tr)
                        prog = self._program("prefill_paged")
                    with SPANS.span("serve.prefill.feed"), \
                            SPANS.unit("feed", dev):
                        prog.feed(tokens=toks, positions=starts,
                                  q_lens=qlens, block_tables=tables)
                    with SPANS.span("serve.prefill.replay"):
                        # writes the round's K/V into the pool storage in
                        # place (the reference donates the cache to its
                        # jitted program)
                        logits = self._replay(prog)
                        real = int(qlens.sum())
                        # FLOPs proxy: every row of the (Bp, C) round
                        # executes, dummy rows included
                        spent += Bp * C
                        self.prefill_tokens += real
                        self.prefill_tokens_executed += Bp * C
                        self.prefill_tokens_padding += Bp * C - real
                        done = []
                        for r, cur in enumerate(sel):
                            cur.pos += int(qlens[r])
                            if tr is not None and tr.enabled and qlens[r]:
                                tr.prefill_advance(cur.slot, int(qlens[r]),
                                                   cur.pos, len(cur.tokens))
                            if cur.done:
                                done.append((r, cur))
                        if done:
                            # an on-device copy (the next round overwrites
                            # the output): no host sync inside the round
                            # loop, so rounds keep dispatching
                            with SPANS.unit("clone", dev):
                                for r, cur in done:
                                    cur.last_logits = logits[
                                        r, int(qlens[r]) - 1].clone()
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
        (max_slots,); rows of free slots carry dummies whose cache writes
        land in the trash block (paged) or in the slot's own stripe, which
        its next prefill overwrites (dense).  Returns logits (max_slots,
        V) **on the device** — pass them straight to ``sample_tokens``."""
        if self.fault_injector is not None:
            # before any state mutation: a decode-site fault leaves the
            # cache untouched, so the scheduler can retry the same step
            self.fault_injector.on_engine_op("decode")
        prog = self._program("decode_step")
        with SPANS.span("serve.decode.feed"):
            with SPANS.unit("feed", self.device):
                prog.feed(tokens=np.asarray(tokens, np.int32)[:, None],
                          positions=np.asarray(positions, np.int32))
                if self.paged:
                    # free slots' rows point at the trash block; a
                    # mid-prefill slot's table maps real blocks already,
                    # so its row is masked to the trash block too — its
                    # dummy decode write at position 0 must not corrupt
                    # KV the prefill just produced.  (A dense mid-prefill
                    # slot prefills into the staging stripe, which
                    # replaces the whole slot stripe when it is done.)
                    # Refreshed in place: the program reads this one
                    # tensor.
                    self.kv.device_block_tables(mask_slots=self._inflight)
            self.recompiles.observe(
                "decode_step", (np.shape(tokens), np.shape(positions)),
                tracer=self.tracer)
            self.kv.check_storage()
        # updates self.kv.cache in place (the reference donates it)
        with SPANS.span("serve.decode.replay"):
            logits = SPANS.replay(prog)
        self.decode_steps += 1
        # on device, no sync here; the next decode round overwrites it
        return logits[:, 0]

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
