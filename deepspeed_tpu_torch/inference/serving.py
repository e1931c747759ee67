"""Continuous batching over the paged KV pool.

Counterpart of ``deepspeed_tpu/inference/serving.py`` (the
``ServingEngine`` core).  A FIFO queue feeds a fixed-width decode batch
(``batch_slots``); a request joins a free slot after its prefill, which
writes its prompt K/V into whole pool blocks, and leaves the step it
finishes, returning its blocks.  Each step runs ONE paged decode for all
slots (``GPT2.decode_step_paged``, whose attention is the CUDA
paged-attention kernel on the card), samples, and joins/evicts.

Each step is one executable, as JAX jits ``_build_decode`` (1156-1211)
and ``_prefill_fn(bucket)`` (1213-1264): with the model's ``decode_impl``
"fused" (the default) on the card, the W=1 decode step (embeddings, the
layers, the head, the non-finite sentinel, the greedy token and the
sentinel token forced into poisoned rows) is one CUDA graph over static
``tables`` / ``lengths`` / ``toks`` buffers, the pool updated in place at
fixed addresses, and each prefill bucket (``blocks_needed(T, block_size)
· block_size`` tokens, the forward at ``min(bucket, max_seq)``, its K/V
zero-padded to the bucket, the real last row's logits taken by a device
index, the greedy first token and the sentinel inside) is one graph
captured at its first use (``runtime/step_graph.py``).  Warm-up and
capture run on tables whose every entry is the scratch block 0, so they
write no seated request's blocks.  ``decode_impl="unroll"`` and the CPU
call the same step bodies directly, op by op.

Ported: ``ServingConfig`` (slots, block size, pool, kv_bits 8|16,
quantizer block, max_new_tokens, top_k, eos, max_queue, speculative),
``Request``, ``submit``, ``_admit``, ``_alloc_blocks``, ``_start``
(prefill) with ``_prefill_fn``, ``step`` (the plain W=1 branch and the
speculative window branch) with ``_build_decode`` (``step`` or
``spec_step``), ``_sample_tokens`` (greedy in the step, sampled rows in
``_draw_sampled``), ``_finish``, ``run``, ``pop_result``, ``results`` and
``stats()``; outcomes ``OK`` and ``POISONED`` with the in-step non-finite
sentinel (a slot whose logits are non-finite is evicted, its blocks
scrubbed and returned, while its neighbours' rows are untouched).

Speculative decoding (``speculative``: JAX ``SpeculativeConfig``,
``ngram_draft``, ``spec_step`` and the window branch of ``step``,
serving.py:140-226, 1176-1211, 2365-2535): each step the host drafts
``k`` tokens per live slot from its committed history (``ngram_draft``
over the last ``DRAFT_WINDOW`` tokens), and ONE captured W=k+1 decode
step (``serving.decode[...,spec{k}]``, which replaces the W=1 step)
scores [current, drafts] for every slot, flags non-finite positions,
takes the greedy token at each and computes each slot's accept length
in the graph.  The host walks the accepted window (a poison keeps the
tokens before it and evicts; eos or ``max_new_tokens`` truncates and
finishes) and advances ``lengths`` by what it emitted: the rejected tail
is never advanced over, which is the rollback.  Greedy streams equal
plain decoding's token for token; a sampled position ``i`` draws with the
plain path's index ``ngen + i``, so sampled streams equal the port's own
plain sampled streams under any arrival order.  ``rec["spec"]`` and
``stats()["speculative"]`` count proposed and accepted drafts (only
drafts that contributed an emitted token).

Deliberate differences:

- the JAX layer scan becomes the model's Python layer loop, captured
  whole into the step's graph;
- sampling: token ``i`` of a request draws from a generator seeded by
  ``(request.seed, i)`` (``engine.sample_seed``) in place of
  ``fold_in(PRNGKey(seed), i)`` — still a pure function of the request,
  whatever the arrival order or slot, but not JAX's bits.  Sampled rows
  are drawn after the replay from the step's static logits (a seeded
  generator per row cannot be replayed); greedy rows never leave the
  graph.  Under speculation a sampled row's accept length is recomputed
  from its drawn tokens on the device after the replay;
- ``speculative.k + 1`` above the paged kernels' ``MAX_WINDOW`` (8,
  ``ops/transformer/paged_attention.py``) raises ``NotImplementedError``
  (JAX scores any window); nothing falls back to the gather path;
- the window's K/V at positions past a slot's own blocks land in the
  shared scratch block as zeros (``paged_kv.write_tokens``), where JAX
  writes the computed values: a quarantined slot's non-finite rows past
  its blocks would otherwise reach its neighbours' masked rows as 0·NaN;
- the parts of JAX's window branch whose modules are not ported are left
  out: prefix-ingestion ``pending``, deadlines, the journal, traces, KV
  snapshots, the monitor bus and the tokens-per-step EMA;
- ``stats()`` adds ``step_ms`` (decode-step wall p50/p99) and ``graphs``
  (the decode impl, graphs, captures, warm-ups, decode and prefill
  replays, and ``pool_bytes``: the graph-pool bytes each graph's capture
  added, by step name);
- int8 weights route through ``resolve_decode_params`` as in JAX
  (560-569): ``self.model`` is the inner model and the pool takes its
  compute dtype (JAX 576), since a quantized engine's ``dtype`` is None;
- the tied head reads the engine's padded copy of ``wte``
  (``InferenceEngine.decode_head``), synced before each step, so no
  captured step pads the 77 MB table (GPT-2 125M);
- ``ServingConfig.from_dict`` raises ``NotImplementedError`` for every
  JAX key the port does not implement yet (prefix cache, roles/transfer,
  journal, KV snapshots, deadlines and overload policy, the poison
  breaker, tracing, sanitizer, preflight).
"""

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import paged_kv as pk
from .engine import InferenceEngine, sample_logits
from ..module_inject.module_quantize import resolve_decode_params
from ..monitor.histogram import LogHistogram
from ..ops.transformer.paged_attention import MAX_WINDOW
from ..runtime.health import rows_nonfinite
from ..runtime.step_graph import GraphPool, StepGraph
from ..utils.logging import log_dist, logger

OK = "ok"                 # completed normally (length or eos)
POISONED = "poisoned"     # quarantined: drove its logits non-finite
OUTCOMES = (OK, POISONED)

# token the sentinel forces into a poisoned slot's sample (never emitted)
POISON_SENTINEL_TOKEN = 0

# keys of the JAX ServingConfig that this port does not implement yet
UNPORTED_KEYS = (
    "preflight", "hbm_budget_bytes", "preflight_safety",
    "deadline_ms", "overload", "queue_high_watermark", "queue_low_watermark",
    "poison_budget", "poison_window", "journal_dir", "forensic_dir",
    "drain_timeout_s", "trace_sample_rate", "sanitize",
    "sanitize_halt", "kv_snapshot", "prefix_cache", "role", "transfer")


class ServingError(RuntimeError):
    """Base of the serving layer's typed errors."""


class QueueFullError(ServingError):
    """``submit()`` refused: the queue holds ``max_queue`` requests."""


class ServingStalledError(ServingError):
    """The scheduler cannot make progress (requests queued, no slot
    active, admission seated nothing), or ``run()`` overran its bound."""


@dataclasses.dataclass
class SpeculativeConfig:
    """The ``serving.speculative`` block (JAX ``SpeculativeConfig``):
    self-drafting n-gram speculation over the paged decode.  Each step the
    drafter proposes ``k`` tokens a live slot (``draft`` "ngram": the
    continuation of the most recent previous occurrence of the slot's
    tail ``ngram``-gram, shorter grams as fallback, then last-token
    repeat) and one W=k+1 decode step scores them.

    Deliberate difference: ``k + 1`` above ``MAX_WINDOW`` (the window the
    paged kernels take) raises ``NotImplementedError``."""
    k: int = 4                      # drafted tokens per slot per step
    draft: str = "ngram"            # the only drafter (self-drafting)
    ngram: int = 3                  # longest tail gram the drafter matches

    def __post_init__(self):
        assert self.k >= 1, f"speculative.k must be >= 1, got {self.k}"
        assert self.draft == "ngram", \
            f"speculative.draft must be 'ngram', got {self.draft!r}"
        assert self.ngram >= 1, \
            f"speculative.ngram must be >= 1, got {self.ngram}"
        if self.k + 1 > MAX_WINDOW:
            raise NotImplementedError(
                f"speculative.k={self.k} scores a window of {self.k + 1} tokens; the paged "
                f"kernels take at most MAX_WINDOW={MAX_WINDOW}")

    @classmethod
    def from_value(cls, v):
        """None/False → off; True → defaults; dict → the JSON block."""
        if not v:
            return None
        if v is True:
            return cls()
        if isinstance(v, cls):
            return v
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(v) - known
        if unknown:
            raise ValueError(
                f"unknown serving.speculative keys: {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(**v)


# the drafter's search window over each slot's committed history (the last
# DRAFT_WINDOW tokens): drafting stays a pure function of the history while
# its host cost a step stays O(window)
DRAFT_WINDOW = 1024


def ngram_draft(history, k: int, ngram: int):
    """The ``k`` tokens that followed the most recent PREVIOUS occurrence
    of the history's tail n-gram (longest gram first, shorter grams as
    fallback; last-token repeat when nothing matches), as int32.  A pure
    function of the slot's committed tokens (JAX ``ngram_draft``)."""
    h = np.asarray(history, np.int64)
    L = h.size
    out = np.full((k,), int(h[-1]) if L else 0, np.int32)
    if L < 2:
        return out
    for order in range(min(ngram, L - 1), 0, -1):
        tail = h[L - order:]
        # every earlier window of `order` tokens (the last one is the tail)
        win = np.lib.stride_tricks.sliding_window_view(h, order)[:L - order]
        hits = np.nonzero((win == tail).all(axis=1))[0]
        if hits.size == 0:
            continue
        start = int(hits[-1]) + order       # the match's continuation
        cont = h[start:start + k]
        if cont.size == 0:
            continue
        out[:cont.size] = cont
        out[cont.size:] = int(cont[-1])
        return out
    return out


def accept_lengths(toks, out):
    """Per slot, 1 + the run of drafts ``toks[:, 1:]`` equal to the tokens
    ``out[:, :-1]`` the window chose before them (JAX ``spec_step``)."""
    match = (toks[:, 1:] == out[:, :-1]).long()
    return 1 + torch.cumprod(match, dim=1).sum(dim=1)


@dataclasses.dataclass
class ServingConfig:
    batch_slots: int = 8            # fixed decode batch width
    block_size: int = 16            # tokens per KV block
    # pool blocks INCLUDING the scratch block 0; 0 → every slot can hold
    # max_seq tokens
    num_blocks: int = 0
    kv_bits: int = 16               # 16 | 8 (int8 payloads + block scales)
    kv_quant_block: int = 64        # quantizer block over the head dim
    max_new_tokens: int = 64        # per-request default
    top_k: Optional[int] = None
    eos_token_id: Optional[int] = None
    max_queue: int = 4096
    # speculative decoding: None/False off, True defaults, or a dict
    # (SpeculativeConfig's fields)
    speculative: Any = None

    def __post_init__(self):
        if self.kv_bits not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {self.kv_bits}")
        if self.batch_slots < 1 or self.block_size < 1:
            raise ValueError("batch_slots and block_size must be >= 1")

    @classmethod
    def from_dict(cls, d: dict) -> "ServingConfig":
        unported = sorted(set(d) & set(UNPORTED_KEYS))
        if unported:
            raise NotImplementedError(
                f"serving config keys {unported} are not implemented by the "
                "PyTorch port yet")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown serving config keys: {sorted(unknown)}"
                             f" (known: {sorted(known)})")
        return cls(**d)


@dataclasses.dataclass
class Request:
    """One generation request; ``seed`` alone determines the sampling
    stream, ``uid`` is assigned by ``submit`` when absent."""
    tokens: Any                     # 1-D int prompt
    max_new_tokens: Optional[int] = None
    temperature: float = 1.0
    do_sample: bool = False
    seed: int = 0
    uid: Optional[int] = None


class _Slot:
    """Host-side state of one active decode-batch slot."""

    def __init__(self, req: Request, blocks: List[int], max_new: int):
        self.req = req
        self.blocks = blocks
        self.max_new = max_new
        self.out_tokens: List[int] = []
        # prompt + emitted tokens: the drafter's input
        self.hist: List[int] = [int(t) for t in req.tokens]
        self.spec_proposed = 0
        self.spec_accepted = 0


class ServingEngine:
    """Continuous-batching scheduler over an :class:`InferenceEngine`.

    Build from a model (``ServingEngine(model=..., params=...)``) or an
    existing engine (``engine=``).  ``config`` is a
    :class:`ServingConfig`, a plain dict, or None for defaults.  The
    device is the engine's (CUDA unless the model was built for the
    CPU)."""

    def __init__(self, model=None, params=None, engine=None, config=None,
                 **engine_kwargs):
        if engine is None:
            engine = InferenceEngine(model=model, params=params,
                                     **engine_kwargs)
        self.engine = engine
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        self.config = config
        # speculative decoding: None = plain one-token decode
        self.spec = SpeculativeConfig.from_value(config.speculative)
        # int8 weights: the same routing as InferenceEngine.generate (a model
        # that decodes int8 leaves itself gets the params untouched)
        inner, self._deq = resolve_decode_params(engine.module)
        if not getattr(inner, "supports_paged_decode", False):
            raise ValueError(f"{type(inner).__name__} has no paged decode path")
        self.model = inner
        # the tied head padded once per engine weight, synced before each step
        self._head = engine.decode_head(inner, self._deq(engine.params))
        self.device = engine.device
        mc = self.model.config
        self.max_seq = mc.max_seq
        self.nb_max = pk.blocks_needed(mc.max_seq, config.block_size)
        self.num_blocks = config.num_blocks or (
            1 + config.batch_slots * self.nb_max)
        self.pool = pk.init_pool(
            mc.n_layer, self.num_blocks, config.block_size, mc.n_head,
            mc.head_dim, getattr(inner, "dtype", torch.bfloat16),
            kv_bits=config.kv_bits, quant_block=config.kv_quant_block,
            device=self.device)
        self.allocator = pk.BlockAllocator(self.num_blocks)
        # "fused": every step one CUDA graph on the card; "unroll" and the CPU
        # call the step bodies directly
        self.decode_impl = inner.decode_impl()
        self._graphs = (GraphPool(self.device) if self.decode_impl == "fused"
                        and self.device.type == "cuda" else None)
        self._decode_step: Optional[StepGraph] = None
        self._prefills: Dict[int, StepGraph] = {}   # bucket → its prefill step

        S = config.batch_slots
        self._slots: List[Optional[_Slot]] = [None] * S
        self._tables = np.zeros((S, self.nb_max), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._toks = np.zeros((S,), np.int64)
        self._seeds = np.zeros((S,), np.int64)
        self._ngen = np.zeros((S,), np.int64)
        self._temps = np.ones((S,), np.float32)
        self._flags = np.zeros((S,), bool)

        self.queue: deque = deque()
        # uid → record; completed records stay until pop_result()
        self.results: Dict[int, dict] = {}
        self._lat_hist = LogHistogram()
        self._ttft_hist = LogHistogram()
        self._step_wall_hist = LogHistogram()   # decode-step wall, ms
        self._completed_total = 0
        self._generated_total = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._next_uid = 0
        self._steps = 0
        self._outcomes = {k: 0 for k in OUTCOMES}
        log_dist(
            f"ServingEngine ready: slots={S} block_size={config.block_size} "
            f"blocks={self.num_blocks} (nb_max={self.nb_max}) "
            f"kv_bits={config.kv_bits} device={self.device} "
            f"decode_impl={self.decode_impl} "
            f"speculative={'off' if self.spec is None else f'k={self.spec.k}'} "
            f"pool={pk.pool_bytes(self.pool) / 1e6:.1f} MB", ranks=[0])

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> int:
        """Queue a request; returns its uid.  Rejects prompts whose
        worst-case length cannot fit ``max_seq`` or the pool
        (ValueError) and a full queue (:class:`QueueFullError`)."""
        toks = np.asarray(req.tokens, np.int64).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty prompt")
        new = (self.config.max_new_tokens if req.max_new_tokens is None
               else int(req.max_new_tokens))
        if new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {new}")
        total = toks.size + new
        if total > self.max_seq:
            raise ValueError(
                f"prompt {toks.size} + max_new_tokens {new} = {total} "
                f"exceeds max_seq {self.max_seq}")
        nb = pk.blocks_needed(total, self.config.block_size)
        if nb > self.num_blocks - 1:
            raise ValueError(
                f"request needs {nb} blocks; the pool only has "
                f"{self.num_blocks - 1} allocatable")
        if req.uid is not None and req.uid in self.results:
            raise ValueError(f"uid {req.uid} already submitted")
        if len(self.queue) >= self.config.max_queue:
            raise QueueFullError(
                f"serving queue is full ({self.config.max_queue} requests)")
        req.tokens = toks
        req.max_new_tokens = new
        if req.uid is None:
            req.uid = self._next_uid
        self._next_uid = max(self._next_uid, req.uid) + 1
        self.results[req.uid] = {"tokens": None, "outcome": None,
                                 "t_submit": time.monotonic(),
                                 "t_first": None, "t_done": None,
                                 "prompt_len": int(toks.size)}
        self.queue.append(req)
        return req.uid

    def _admit(self):
        """Move queue-head requests into free slots while blocks last
        (strict FIFO: a blocked head waits rather than being overtaken)."""
        while self.queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            req: Request = self.queue[0]
            nb = pk.blocks_needed(len(req.tokens) + req.max_new_tokens,
                                  self.config.block_size)
            blocks = self._alloc_blocks(nb)
            if blocks is None:
                return
            self.queue.popleft()
            try:
                self._start(free[0], req, blocks)
            except BaseException:
                # a prefill that dies must not leak the blocks (unless the
                # slot was seated and owns them, or they were returned)
                if (self._slots[free[0]] is None
                        and all(self.allocator.is_allocated(b)
                                for b in blocks)):
                    self.allocator.free(blocks)
                raise

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        return self.allocator.alloc(n)

    @torch.no_grad()
    def _start(self, slot: int, req: Request, blocks: List[int]):
        """Prefill one request through its bucket's step (JAX ``_start``:
        the prompt zero-padded to ``blocks_needed(T) · block_size``
        tokens), write its K/V into its first blocks, and sample the
        first token."""
        c = self.config
        T = int(len(req.tokens))
        bucket = pk.blocks_needed(T, c.block_size) * c.block_size
        toks = np.zeros((1, min(bucket, self.max_seq)), np.int64)
        toks[0, :T] = req.tokens
        self._head.sync()
        row, first, bad = self._prefill_step(bucket)(
            toks=toks, blocks=np.asarray(blocks[:bucket // c.block_size], np.int64),
            t_real=np.int64(T))
        if req.do_sample:
            first = self._draw_sampled(row, first, bad,
                                       [(0, req.seed, 0, req.temperature)])
        first, bad = (int(x) for x in torch.stack(
            [first[0], bad[0].long()]).cpu())
        if bad:
            # quarantined at prefill: never seated, blocks scrubbed and
            # returned, the sentinel token never surfaced
            self._scrub_blocks(blocks)
            self.allocator.free(blocks)
            logger.warning(f"serving: request {req.uid} QUARANTINED at "
                           f"prefill — non-finite logits")
            self._finalize_unseated(req, POISONED)
            return
        s = _Slot(req, blocks, req.max_new_tokens)
        s.out_tokens.append(first)
        s.hist.append(first)
        self._slots[slot] = s
        self._tables[slot] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = T
        self._toks[slot] = first
        self._seeds[slot] = req.seed
        self._ngen[slot] = 1
        self._temps[slot] = req.temperature
        self._flags[slot] = req.do_sample
        self.results[req.uid]["t_first"] = time.monotonic()
        if req.max_new_tokens == 1 or first == c.eos_token_id:
            self._finish(slot)

    def _finalize_unseated(self, req: Request, outcome: str):
        rec = self.results[req.uid]
        rec["tokens"] = None
        rec["outcome"] = outcome
        rec["t_done"] = time.monotonic()
        self._outcomes[outcome] += 1

    # ---------------------------------------------------------------- steps
    def _prefill_step(self, bucket: int) -> StepGraph:
        """The prefill of prompts padded to ``bucket`` tokens, one step
        per bucket built at its first use (JAX ``_prefill_fn``).  Its
        warm-up and capture write the scratch block only."""
        step = self._prefills.get(bucket)
        if step is None:
            fwd_len = min(bucket, self.max_seq)
            z = lambda *shape: torch.zeros(shape, dtype=torch.long)
            step = self._prefills[bucket] = StepGraph(
                f"serving.prefill[{bucket},kv{self.config.kv_bits}]",
                lambda toks, blocks, t_real: self._prefill_body(bucket, toks, blocks,
                                                                t_real),
                {"toks": z(1, fwd_len), "blocks": z(bucket // self.config.block_size),
                 "t_real": torch.tensor(fwd_len)},
                self.device, self._graphs)
        return step

    def _prefill_body(self, bucket, toks, blocks, t_real):
        """``toks`` (1, fwd_len) → ``(row (1, V) fp32, first (1,), bad
        (1,))``: the forward at ``fwd_len = min(bucket, max_seq)`` tokens,
        its K/V zero-padded to the bucket and scattered into ``blocks``,
        the logits of row ``t_real - 1`` (a device index), the greedy
        first token with the sentinel forced where they are non-finite."""
        model = self.model
        fwd_len = toks.shape[1]
        cache = model.init_cache(1, fwd_len)
        logits, cache = model.apply_with_cache(self._deq(self.engine.params), toks, cache,
                                               self._head.weight)
        k, v = cache["k"][:, :, 0], cache["v"][:, :, 0]     # (L, fwd_len, H, hd)
        if fwd_len < bucket:
            pad = (0, 0, 0, 0, 0, bucket - fwd_len)
            k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        pk.write_prefill(self.pool, blocks, k, v)
        row = logits[0].index_select(0, t_real.reshape(1) - 1)
        bad = rows_nonfinite(row)
        first = torch.argmax(row, dim=-1).masked_fill(bad, POISON_SENTINEL_TOKEN)
        return row, first, bad

    def _decode_graph(self) -> StepGraph:
        """The decode step over static ``toks`` / ``tables`` / ``lengths``
        (JAX ``_build_decode``), built at first use: the W=1 step, or with
        speculation the W=k+1 one in its place (``toks`` then (S, k+1));
        its warm-up and capture run on all-scratch tables."""
        if self._decode_step is None:
            S, c = self.config.batch_slots, self.config
            spec = f",spec{self.spec.k}" if self.spec is not None else ""
            toks = (S,) if self.spec is None else (S, self.spec.k + 1)
            self._decode_step = StepGraph(
                f"serving.decode[{S}x{self.nb_max}x{c.block_size},kv{c.kv_bits}{spec}]",
                self._decode_body,
                {"toks": torch.zeros(toks, dtype=torch.long),
                 "tables": torch.zeros((S, self.nb_max), dtype=torch.int32),
                 "lengths": torch.zeros((S,), dtype=torch.int32)},
                self.device, self._graphs)
        return self._decode_step

    def _decode_body(self, toks, tables, lengths):
        """One decode step for every slot (JAX ``step``, 1161-1178):
        ``(logits (S, V) fp32, greedy tokens (S,), poisoned (S,))``, the
        sentinel token forced into poisoned rows.  The pool is updated in
        place.  With a (S, W) window [current, drafts] (JAX ``spec_step``,
        1176-1204) each of those gains a window axis, position i's logits
        being what plain decode sees at generation index ``ngen + i``, and
        the accept lengths (S,) follow."""
        logits, _ = self.model.decode_step_paged(
            self._deq(self.engine.params), toks, self.pool, tables, lengths,
            self._head.weight)
        poisoned = rows_nonfinite(logits)
        nxt = torch.argmax(logits, dim=-1).masked_fill(poisoned, POISON_SENTINEL_TOKEN)
        if toks.dim() == 1:
            return logits, nxt, poisoned
        return logits, nxt, poisoned, accept_lengths(toks, nxt)

    def _draw_sampled(self, logits, nxt, bad, rows):
        """``nxt`` with each sampled row ``(i, seed, index, temperature)``
        drawn from ``logits[i]`` by the ``(seed, index)`` stream, the
        sentinel kept where ``bad``; on the device, after the step."""
        nxt = nxt.clone()
        for i, seed, index, temp in rows:
            nxt[i] = sample_logits(logits[i], float(temp), self.config.top_k,
                                   int(seed), int(index))
        return nxt.masked_fill(bad, POISON_SENTINEL_TOKEN)

    # ------------------------------------------------------------- scheduler
    def _window(self, active):
        """The decode step's ``toks`` for the ``active`` slots: the current
        tokens (S,), or with speculation the window (S, k+1) [current,
        drafts], the drafts from each slot's committed history, on the
        host, before the static window is refilled."""
        if self.spec is None:
            return self._toks
        win = np.repeat(self._toks[:, None], self.spec.k + 1, axis=1)
        for i in active:
            win[i, 1:] = ngram_draft(self._slots[i].hist[-DRAFT_WINDOW:], self.spec.k,
                                     self.spec.ngram)
        return win

    @torch.no_grad()
    def _decode(self, active):
        """One decode step for every slot: ``(tokens (S, W), accept lengths
        (S,), non-finite (S, W))`` as host arrays, W = 1 without
        speculation (every token accepted).  The sentinel is computed on
        the device before the host reads anything, and the host reads
        once."""
        step = self._decode_graph()
        self._head.sync()
        S = self.config.batch_slots
        res = step(toks=self._window(active), tables=self._tables, lengths=self._lengths)
        if self.spec is None:
            logits, out, bad = (t[:, None] for t in res)
            accept = None
        else:
            logits, out, bad, accept = res
        W = out.shape[1]
        # a sampled window position j draws with the plain path's index ngen + j
        sampled = [(i * W + j, self._seeds[i], self._ngen[i] + j, self._temps[i])
                   for i in active if self._flags[i] for j in range(W)]
        if sampled:
            out = self._draw_sampled(logits.reshape(S * W, -1), out.reshape(-1),
                                     bad.reshape(-1), sampled).reshape(S, W)
            if accept is not None:
                accept = accept_lengths(step.static["toks"], out)
        host = torch.cat([out, bad.long()] + ([] if accept is None else [accept[:, None]]),
                         dim=1).cpu().numpy()
        accept = np.ones((S,), np.int64) if accept is None else host[:, -1]
        return host[:, :W], accept, host[:, W:2 * W].astype(bool)

    def step(self) -> bool:
        """One scheduler iteration: admit, ONE decode for the whole batch
        (a W=k+1 window under speculation), sample, join/evict.  Returns
        False when nothing is left."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            if self.queue:
                self._raise_stalled()
            return False
        t0 = time.perf_counter()
        out, accept, nonfin = self._decode(active)
        # the host read above synced the step: this is its true wall time
        self._step_wall_hist.add((time.perf_counter() - t0) * 1e3)
        self._steps += 1
        c = self.config
        for i in active:
            s = self._slots[i]
            # the emission plan: the accepted window, cut by a poison (the
            # tokens before it kept) or by eos / max_new (the slot finishes)
            plan, poisoned, finished = [], False, False
            for j in range(int(accept[i])):
                if nonfin[i, j]:
                    poisoned = True
                    break
                tok = int(out[i, j])
                plan.append(tok)
                if len(s.out_tokens) + len(plan) >= s.max_new or tok == c.eos_token_id:
                    finished = True
                    break
            if self.spec is not None:
                # only drafts that contributed an emitted token count as accepted
                used = max(0, len(plan) - 1)
                s.spec_proposed += self.spec.k
                s.spec_accepted += used
                self._spec_proposed_total += self.spec.k
                self._spec_accepted_total += used
            s.out_tokens.extend(plan)
            s.hist.extend(plan)
            if poisoned:
                self._evict_poisoned(i)
                continue
            if finished:
                self._finish(i)
                continue
            # the rejected tail is never advanced over: that is the rollback
            self._lengths[i] += len(plan)
            self._ngen[i] += len(plan)
            self._toks[i] = s.out_tokens[-1]
        return True

    def _raise_stalled(self):
        req: Request = self.queue[0]
        nb = pk.blocks_needed(len(req.tokens) + req.max_new_tokens,
                              self.config.block_size)
        raise ServingStalledError(
            f"serving stalled: {len(self.queue)} request(s) queued, zero "
            f"slots active — head uid {req.uid} needs {nb} block(s) but the "
            f"allocator has {self.allocator.free_blocks} free of "
            f"{self.num_blocks - 1} allocatable")

    @torch.no_grad()
    def _scrub_blocks(self, blocks: List[int]):
        """Reset ``blocks`` of every layer to zeros (unit scales for an
        int8 pool), in place.  A scrub keeps a stale non-finite row from
        leaking into the block's next tenant through the masked tail
        (0·NaN = NaN)."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        if pk.is_quantized_pool(self.pool):
            self.pool["k_scale"][:, idx] = 1.0
            self.pool["v_scale"][:, idx] = 1.0
        else:
            self.pool["k"][:, idx] = 0.0
            self.pool["v"][:, idx] = 0.0

    def _finish(self, slot: int, outcome: str = OK):
        s = self._slots[slot]
        if outcome == POISONED:
            self._scrub_blocks(s.blocks)
        self.allocator.free(s.blocks)
        rec = self.results[s.req.uid]
        rec["tokens"] = list(s.out_tokens)
        rec["outcome"] = outcome
        rec["t_done"] = time.monotonic()
        if self.spec is not None:
            rec["spec"] = {"proposed": s.spec_proposed, "accepted": s.spec_accepted}
        self._outcomes[outcome] += 1
        self._generated_total += len(s.out_tokens)
        if outcome == OK:
            self._completed_total += 1
            self._lat_hist.add((rec["t_done"] - rec["t_submit"]) * 1e3)
            if rec["t_first"] is not None:
                self._ttft_hist.add((rec["t_first"] - rec["t_submit"]) * 1e3)
        self._slots[slot] = None
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._toks[slot] = 0
        self._seeds[slot] = 0
        self._ngen[slot] = 0
        self._temps[slot] = 1.0
        self._flags[slot] = False

    def _evict_poisoned(self, slot: int):
        logger.warning(
            f"serving: request {self._slots[slot].req.uid} QUARANTINED — its "
            f"decode logits went non-finite; evicted, blocks scrubbed")
        self._finish(slot, outcome=POISONED)

    def run(self, requests=None, max_steps: int = 10 ** 6) -> Dict[int, dict]:
        """Submit ``requests`` (if given) and step until the queue drains
        and every slot completes.  Returns ``self.results``."""
        for r in requests or ():
            self.submit(r)
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise ServingStalledError(
                    f"serving run exceeded {max_steps} steps with work "
                    f"still pending ({len(self.queue)} queued)")
        return self.results

    # ------------------------------------------------------------- reporting
    def pop_result(self, uid: int) -> dict:
        """Take a completed request's record out of ``results``.  KeyError
        for an unknown uid, RuntimeError for one still in flight."""
        rec = self.results[uid]
        if rec["t_done"] is None:
            raise RuntimeError(f"request {uid} is still in flight")
        return self.results.pop(uid)

    def stats(self) -> dict:
        """Counts plus p50/p99/p999 submit→done and submit→first-token
        and decode-step wall (ms) over every completion, the step graphs'
        counters and pool bytes, and with speculation the drafts proposed
        and accepted."""
        out = {"completed": self._completed_total,
               "pending": len(self.queue) + sum(
                   s is not None for s in self._slots),
               "decode_steps": self._steps,
               "generated_tokens": self._generated_total,
               "outcomes": dict(self._outcomes)}
        dec = [self._decode_step] if self._decode_step is not None else []
        pre = list(self._prefills.values())
        out["graphs"] = {
            "decode_impl": self.decode_impl,
            "graphs": sum(s.captured for s in dec + pre),
            "captures": sum(s.captures for s in dec + pre),
            "decode_warmups": sum(s.warmups for s in dec),
            "prefill_warmups": sum(s.warmups for s in pre),
            "decode_replays": sum(s.replays for s in dec),
            "prefill_replays": sum(s.replays for s in pre),
            "pool_bytes": {s.name: s.pool_bytes for s in dec + pre}}
        if self.spec is not None:
            out["speculative"] = {
                "k": self.spec.k,
                "proposed": self._spec_proposed_total,
                "accepted": self._spec_accepted_total,
                "accept_rate": round(self._spec_accepted_total
                                     / max(1, self._spec_proposed_total), 4),
                "tokens_per_step": round(self._generated_total / max(1, self._steps), 2)}
        for name, h in (("latency_ms", self._lat_hist),
                        ("ttft_ms", self._ttft_hist),
                        ("step_ms", self._step_wall_hist)):
            if h:
                p = h.percentiles()
                out[name] = {k: p[k] for k in ("p50", "p99", "p999", "max")}
        return out
