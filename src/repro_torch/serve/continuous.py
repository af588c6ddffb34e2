"""Continuous (in-flight) batching over a paged KV cache (the port of
``repro.serve.continuous``).

The scheduler keeps a fixed-width decode batch (``max_batch`` rows) and
admits/retires *per decode step*: a request occupies a row for exactly its
own ``n_new`` steps, new requests slot into freed rows immediately, and
admission is gated by the paged-KV free list.

Time is a *virtual step clock* (one tick per engine step) so arrival
traces (``serve.arrivals``) replay deterministically; latencies are
measured on the wall clock via tracer spans, each of which ends after the
sampled tokens reach the host (a sync), so on the card a span times the
device work.

Design notes:

* The paged pools are the source of truth.  Decode runs on a dense
  working cache (cycles, max_batch, s_max, ...); each step commits the
  newly written position of every live row back to the pools, and any
  admission rebuilds the working cache *from* the pools
  (``PagedKVCache.gather_batch``).  Pools and working cache live on the
  device.
* Prefill runs per request at batch 1: whole-prompt, padded to a
  power-of-two bucket, as JAX's (a Mamba slot's state and conv tail take
  in the pad tokens there, so the tokens are JAX's, not those of the
  prompt alone: ROADMAP, faults in the reference), or chunked
  (``prefill_chunk > 0``: ``model.extend_step``, one chunk a scheduler
  tick, so a long prompt does not stall the admitted rows).  Chunked
  prefill needs an attention-only stack (``model.supports_extend``);
  other configs take whole-prompt prefill, as JAX's do.  A request's
  chunked cache is linear at ``s_max`` in every slot, the pool's layout
  (``empty_caches``): a sliding-window slot keeps every position and
  ``gqa_extend``'s mask applies the window.  (JAX's holds a sliding-
  window slot's ``min(s_max, window)`` positions, drops the positions
  past it and fails copying the short cache into the pool: ROADMAP,
  faults in the reference.)
* Prompts are (L,) or, for a K-codebook model, (L, K); each request's
  tokens come back (n_new,) or (n_new, K).
* Dummy rows decode a masked token-0 at their stale position; their cache
  writes are never committed to the pools and vanish at the next
  admission's regather.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import resolve_device, tree_map
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.trace import monotonic
from repro_torch.serve.engine import greedy, place_prefill_cache
from repro_torch.serve.kvcache import PagedKVCache


def _bucket(n: int, cap: int) -> int:
    """Pad prompts to power-of-two buckets (bounds the prefill shapes)."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray  # (L,) or (L, K) int32
    n_new: int
    arrival_step: int = 0
    # runtime state
    tokens: List[np.ndarray] = field(default_factory=list)
    prefill_done: int = 0
    caches: Any = None  # B=1 private cache during (chunked) prefill
    t_arrive: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0

    @property
    def length(self) -> int:
        return int(self.prompt.shape[0])


class ContinuousEngine:
    """Model-level primitives for the continuous scheduler: per-request
    prefill (whole or chunked, batch 1) and one fixed-width decode step.
    ``prefill_chunk`` is kept only where ``model.supports_extend`` holds
    (0 otherwise: whole-prompt prefill, as JAX's)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params=None, *,
                 s_max: int = 512, max_batch: int = 4,
                 prefill_chunk: int = 0, seed: int = 0, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.run = run
        self.s_max = s_max
        self.max_batch = max_batch
        self.prefill_chunk = (prefill_chunk if prefill_chunk > 0
                              and M.supports_extend(cfg) else 0)
        self.device = resolve_device(device)
        self.tracer = (tracer if tracer is not None and tracer.enabled
                       else Tracer(enabled=True))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if params is None:
            params = M.init_params(cfg, seed, self.device)
        self.params = M.cast_params(params, cfg)

    def empty_caches(self, batch: int):
        """Zero bf16 linear caches of ``s_max`` positions: the shapes of
        ``model.cache_specs`` with a sliding-window slot's sequence axis
        widened from min(s_max, window) to s_max."""
        specs = M.cache_specs(self.cfg, batch=batch, s_max=self.s_max)
        return tree_map(lambda sp: torch.zeros(
            sp.shape[:2] + (self.s_max,) + sp.shape[3:],
            dtype=torch.bfloat16, device=self.device), specs)

    def _prompt(self, req: ServeRequest, lo: int, n: int, width: int):
        """(1, width[, K]) int32 on the device: prompt[lo:lo + n], zeros
        after."""
        toks = torch.zeros((1, width) + req.prompt.shape[1:],
                           dtype=torch.int32, device=self.device)
        toks[0, :n] = torch.as_tensor(req.prompt[lo:lo + n],
                                      device=self.device)
        return toks

    def prefill_whole(self, req: ServeRequest):
        """Whole-prompt prefill at batch 1: fills req.caches (linear,
        s_max, bf16) and returns the first sampled token."""
        L = req.length
        toks = self._prompt(req, 0, L, _bucket(L, self.s_max))
        logits, caches, _ = M.forward(self.params, {"tokens": toks}, self.cfg,
                                      self.run, with_cache=True)
        req.caches = place_prefill_cache(self.cfg, caches, self.s_max, L,
                                         ring=False)
        req.prefill_done = L
        return greedy(logits[:, L - 1], self.metrics)[0]

    def prefill_chunk_step(self, req: ServeRequest):
        """Advance a chunked prefill by one chunk.  Returns the first
        sampled token once the prompt is complete, else None."""
        C = self.prefill_chunk
        if req.caches is None:
            req.caches = self.empty_caches(1)
        L, done = req.length, req.prefill_done
        n = min(C, L - done)
        pos0 = torch.full((1,), done, dtype=torch.int32, device=self.device)
        logits, req.caches = M.extend_step(
            self.params, self._prompt(req, done, n, C), pos0, req.caches,
            self.cfg, self.run)
        req.prefill_done = done + n
        if req.prefill_done >= L:
            return greedy(logits[:, n - 1], self.metrics)[0]
        return None

    def decode(self, tokens: np.ndarray, pos: np.ndarray, caches):
        """One step across all rows. tokens (B,[K]) pos (B,) — returns
        (sampled (B,[K]), new_caches)."""
        tk = torch.as_tensor(tokens, device=self.device)[:, None]
        p = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        logits, caches = M.decode_step(self.params, tk, p, caches, self.cfg,
                                       self.run, self.s_max)
        return greedy(logits[:, -1], self.metrics), caches


class ContinuousScheduler:
    """Admission, retirement and accounting around a ContinuousEngine."""

    def __init__(self, engine: ContinuousEngine, kv: PagedKVCache):
        self.engine = engine
        self.kv = kv
        self.queue: List[ServeRequest] = []
        self._next_id = 0
        self.stats: Dict[str, Any] = {}
        self.latencies: Dict[int, float] = {}
        self.first_token_s: Dict[int, float] = {}

    def submit(self, prompt: np.ndarray, n_new: int,
               arrival_step: int = 0) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(ServeRequest(rid, np.asarray(prompt, np.int32),
                                       int(n_new), int(arrival_step)))
        return rid

    def run(self) -> Dict[int, np.ndarray]:
        eng, kv, m = self.engine, self.kv, self.engine.metrics
        B = eng.max_batch
        self.queue.sort(key=lambda r: (r.arrival_step, r.rid))
        pending = list(self.queue)
        total = len(pending)
        self.queue = []
        self.latencies = {}
        self.first_token_s = {}
        if not pending:
            self.stats = {"engine_steps": 0, "decode_token_steps": 0,
                          "wasted_decode_steps": 0, "idle_row_slots": 0,
                          "prefill_chunks": 0, "delivered_tokens": 0,
                          "virtual_steps": 0, "requests": 0}
            return {}

        rows: List[Optional[ServeRequest]] = [None] * B  # active rows
        prefilling: List[ServeRequest] = []  # admitted, prompt in flight
        ready: List[ServeRequest] = []
        results: Dict[int, np.ndarray] = {}
        tokens = np.zeros((B,) + pending[0].prompt.shape[1:], np.int32)
        pos = np.zeros((B,), np.int32)
        remaining = np.full((B,), -1, np.int64)  # -1 = row not decoding
        state = {"retired": 0, "dirty": False}
        clock = 0
        engine_steps = work_slots = prefill_chunks = 0
        caches = None

        def retire(req: ServeRequest, row: int) -> None:
            req.t_finish = monotonic()
            self.latencies[req.rid] = req.t_finish - req.t_arrive
            results[req.rid] = np.stack(req.tokens)
            kv.release(req.rid)
            m.inc("serve/requests")
            m.inc("serve/tokens", req.n_new)
            rows[row] = None
            remaining[row] = -1
            state["retired"] += 1
            state["dirty"] = True  # freed row: next admission regathers

        def activate(req: ServeRequest, row: int, first_token) -> None:
            """Prompt is in the pools; the row decodes from the next step."""
            kv.write_prefill(req.rid, req.caches, req.length)
            req.caches = None  # working cache now comes from the pools
            req.tokens = [np.asarray(first_token, np.int32)]
            req.t_first = monotonic()
            self.first_token_s[req.rid] = req.t_first - req.t_arrive
            tokens[row] = first_token
            pos[row] = req.length
            remaining[row] = req.n_new - 1
            state["dirty"] = True
            if remaining[row] == 0:  # single-token request: done already
                retire(req, row)

        while state["retired"] < total:
            while pending and pending[0].arrival_step <= clock:
                req = pending.pop(0)
                req.t_arrive = monotonic()
                ready.append(req)
            m.observe("serve/queue_depth", len(ready))

            # admit: free row + free KV blocks reserve the whole lifetime
            while ready and None in rows:
                req = ready[0]
                need = req.length + req.n_new
                if need > eng.s_max:
                    raise ValueError(
                        f"request {req.rid}: prompt+n_new={need} exceeds "
                        f"s_max={eng.s_max}")
                if not kv.can_admit(req.prompt, need):
                    if not any(rows) and not prefilling:
                        raise RuntimeError(
                            f"request {req.rid} cannot fit in an empty KV "
                            f"pool ({kv.alloc.n_blocks} blocks)")
                    break
                ready.pop(0)
                kv.admit(req.rid, req.prompt, need)
                row = rows.index(None)
                rows[row] = req
                remaining[row] = -1  # prefilling sentinel: not decoding yet
                if eng.prefill_chunk and req.length > eng.prefill_chunk:
                    prefilling.append(req)
                else:
                    with eng.tracer.span("prefill", rid=req.rid,
                                         prompt_len=req.length) as sp:
                        first = eng.prefill_whole(req)
                    m.observe("serve/prefill_s", sp.elapsed_s)
                    activate(req, row, first)

            # one prefill chunk per tick: long prompts interleave with decode
            if prefilling:
                req = prefilling[0]
                with eng.tracer.span("prefill_chunk", rid=req.rid,
                                     done=req.prefill_done) as sp:
                    first = eng.prefill_chunk_step(req)
                m.observe("serve/prefill_chunk_s", sp.elapsed_s)
                prefill_chunks += 1
                if first is not None:
                    prefilling.pop(0)
                    m.observe("serve/prefill_s", sp.elapsed_s)
                    activate(req, rows.index(req), first)

            active = [i for i in range(B) if remaining[i] > 0]
            if not active:
                if not prefilling and not ready and pending:
                    clock = pending[0].arrival_step  # idle fast-forward
                else:
                    clock += 1
                continue

            if state["dirty"]:
                caches = kv.gather_batch(
                    [rows[i].rid if i in active else None for i in range(B)])
                state["dirty"] = False

            m.observe("serve/batch_size", len(active))
            with eng.tracer.span("decode_step", step=clock,
                                 live=len(active)) as sp:
                sampled, caches = eng.decode(tokens, pos, caches)
            m.observe("serve/decode_s", sp.elapsed_s)
            m.observe("serve/decode_token_s", sp.elapsed_s / len(active))
            engine_steps += 1
            work_slots += len(active)
            m.inc("serve/decode_token_steps", len(active))

            kv.commit_token([rows[i].rid for i in active], active,
                            pos[active], caches)
            for i in active:
                req = rows[i]
                req.tokens.append(sampled[i])
                pos[i] += 1
                remaining[i] -= 1
                tokens[i] = sampled[i]
                if remaining[i] == 0:
                    retire(req, i)
            m.set_gauge("serve/kv_blocks_used", kv.alloc.n_used)
            clock += 1

        # tokens *computed*: one per live-row decode slot plus the
        # prefill-sampled first token of each request — equals sum(n_new)
        delivered = sum(len(t) for t in results.values())
        self.stats = {"engine_steps": engine_steps,
                      "decode_token_steps": work_slots + total,
                      "wasted_decode_steps": work_slots + total - delivered,
                      "idle_row_slots": engine_steps * B - work_slots,
                      "prefill_chunks": prefill_chunks,
                      "delivered_tokens": delivered,
                      "virtual_steps": clock,
                      "requests": total}
        return results
