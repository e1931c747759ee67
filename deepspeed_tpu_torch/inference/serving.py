"""Continuous batching over the paged KV pool.

Counterpart of ``deepspeed_tpu/inference/serving.py`` (the
``ServingEngine`` core).  A FIFO queue feeds a fixed-width decode batch
(``batch_slots``); a request joins a free slot after its prefill, which
writes its prompt K/V into whole pool blocks, and leaves the step it
finishes, returning its blocks.  Each step runs ONE paged decode for all
slots (``GPT2.decode_step_paged``, whose attention is the CUDA
paged-attention kernel on the card), samples, and joins/evicts.

Ported: ``ServingConfig`` (slots, block size, pool, kv_bits 8|16,
quantizer block, max_new_tokens, top_k, eos, max_queue), ``Request``,
``submit``, ``_admit``, ``_alloc_blocks``, ``_start`` (prefill),
``step`` (the plain W=1 branch), ``_sample_tokens``, ``_finish``,
``run``, ``pop_result``, ``results`` and ``stats()``; outcomes ``OK``
and ``POISONED`` with the in-step non-finite sentinel (a slot whose
logits are non-finite is evicted, its blocks scrubbed and returned,
while its neighbours' rows are untouched).

Deliberate differences:

- no bucket padding: eager PyTorch has no recompiles, so the prefill
  runs the prompt's own length and zero-pads the K/V up to whole blocks
  for ``write_prefill``;
- the JAX layer scan becomes the model's Python layer loop;
- sampling: token ``i`` of a request draws from a generator seeded by
  ``(request.seed, i)`` (``engine.sample_seed``) in place of
  ``fold_in(PRNGKey(seed), i)`` — still a pure function of the request,
  whatever the arrival order or slot, but not JAX's bits;
- ``stats()`` adds ``step_ms`` (decode-step wall p50/p99);
- ``ServingConfig.from_dict`` raises ``NotImplementedError`` for every
  JAX key the port does not implement yet (speculative decoding, prefix
  cache, roles/transfer, journal, KV snapshots, deadlines and overload
  policy, the poison breaker, tracing, sanitizer, preflight).
"""

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import paged_kv as pk
from .engine import InferenceEngine, sample_logits
from ..monitor.histogram import LogHistogram
from ..runtime.health import rows_nonfinite
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
    "drain_timeout_s", "trace_sample_rate", "speculative", "sanitize",
    "sanitize_halt", "kv_snapshot", "prefix_cache", "role", "transfer")


class ServingError(RuntimeError):
    """Base of the serving layer's typed errors."""


class QueueFullError(ServingError):
    """``submit()`` refused: the queue holds ``max_queue`` requests."""


class ServingStalledError(ServingError):
    """The scheduler cannot make progress (requests queued, no slot
    active, admission seated nothing), or ``run()`` overran its bound."""


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
        self.model = engine.module
        self.device = engine.device
        mc = self.model.config
        self.max_seq = mc.max_seq
        self.nb_max = pk.blocks_needed(mc.max_seq, config.block_size)
        self.num_blocks = config.num_blocks or (
            1 + config.batch_slots * self.nb_max)
        self.pool = pk.init_pool(
            mc.n_layer, self.num_blocks, config.block_size, mc.n_head,
            mc.head_dim, engine.dtype, kv_bits=config.kv_bits,
            quant_block=config.kv_quant_block, device=self.device)
        self.allocator = pk.BlockAllocator(self.num_blocks)

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
        self._next_uid = 0
        self._steps = 0
        self._outcomes = {k: 0 for k in OUTCOMES}
        log_dist(
            f"ServingEngine ready: slots={S} block_size={config.block_size} "
            f"blocks={self.num_blocks} (nb_max={self.nb_max}) "
            f"kv_bits={config.kv_bits} device={self.device} "
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
        """Prefill one request (B=1, its own length), write its K/V into
        its first blocks, and sample the first token."""
        c = self.config
        model = self.model
        T = int(len(req.tokens))
        nb_pre = pk.blocks_needed(T, c.block_size)
        toks = torch.as_tensor(req.tokens, dtype=torch.long,
                               device=self.device)[None]
        cache = model.init_cache(1, T)
        logits, cache = model.apply_with_cache(self.engine.params, toks, cache)
        k, v = cache["k"][:, :, 0], cache["v"][:, :, 0]     # (L, T, H, hd)
        pad = nb_pre * c.block_size - T
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pk.write_prefill(self.pool, blocks[:nb_pre], k, v)
        row = logits[0, T - 1][None]
        bad = rows_nonfinite(row)[0]
        first = self._sample_tokens(row, [req.seed], [0], [req.temperature],
                                    [req.do_sample])[0]
        first, bad = (int(x) for x in torch.stack(
            [first, bad.long()]).cpu())
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

    # -------------------------------------------------------------- sampling
    def _sample_tokens(self, logits, seeds, ngen, temps, flags):
        """(B, V) fp32 → (B,) int64 on the device: greedy argmax, or for
        flagged rows a draw keyed on ``(seed, token index)`` alone."""
        out = torch.argmax(logits, dim=-1)
        for i, flag in enumerate(flags):
            if flag:
                out[i] = sample_logits(logits[i], float(temps[i]),
                                       self.config.top_k, int(seeds[i]),
                                       int(ngen[i]))
        return out

    # ------------------------------------------------------------- scheduler
    @torch.no_grad()
    def _decode(self, active):
        """One decode step for every slot: ``(next tokens, poisoned)`` as
        host arrays.  The sentinel is computed on the device before the
        host reads anything."""
        dev = self.device
        logits, self.pool = self.model.decode_step_paged(
            self.engine.params,
            torch.as_tensor(self._toks, device=dev),
            self.pool,
            torch.as_tensor(self._tables, device=dev),
            torch.as_tensor(self._lengths, device=dev))
        poisoned = rows_nonfinite(logits)
        flags = [bool(self._flags[i]) and i in active
                 for i in range(len(self._slots))]
        nxt = self._sample_tokens(logits, self._seeds, self._ngen,
                                  self._temps, flags)
        nxt = torch.where(poisoned, torch.full_like(nxt, POISON_SENTINEL_TOKEN),
                          nxt)
        host = torch.stack([nxt, poisoned.long()]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def step(self) -> bool:
        """One scheduler iteration: admit, ONE decode for the whole
        batch, sample, join/evict.  Returns False when nothing is left."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            if self.queue:
                self._raise_stalled()
            return False
        t0 = time.perf_counter()
        nxt, poisoned = self._decode(active)
        # the host read above synced the step: this is its true wall time
        self._step_wall_hist.add((time.perf_counter() - t0) * 1e3)
        self._steps += 1
        c = self.config
        for i in active:
            s = self._slots[i]
            if poisoned[i]:
                self._evict_poisoned(i)
                continue
            tok = int(nxt[i])
            s.out_tokens.append(tok)
            if len(s.out_tokens) >= s.max_new or tok == c.eos_token_id:
                self._finish(i)
                continue
            self._lengths[i] += 1
            self._ngen[i] += 1
            self._toks[i] = tok
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
        and decode-step wall (ms) over every completion."""
        out = {"completed": self._completed_total,
               "pending": len(self.queue) + sum(
                   s is not None for s in self._slots),
               "decode_steps": self._steps,
               "generated_tokens": self._generated_total,
               "outcomes": dict(self._outcomes)}
        for name, h in (("latency_ms", self._lat_hist),
                        ("ttft_ms", self._ttft_hist),
                        ("step_ms", self._step_wall_hist)):
            if h:
                p = h.percentiles()
                out[name] = {k: p[k] for k in ("p50", "p99", "p999", "max")}
        return out
