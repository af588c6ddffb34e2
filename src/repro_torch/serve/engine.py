"""Serving engine (the port of ``repro.serve.engine``): batched prefill ->
cached decode with fixed-size linear cache buffers, and the FIFO
``BatchScheduler``.

Right-padded prompts + per-example ``pos`` masking means ragged batches
share one prefill (a Mamba slot's state takes in a shorter row's pad
tokens, as JAX's does: ROADMAP, faults in the reference); the decode
loop is one step per token across the whole batch.  ``prefill`` and
``decode`` are tracer spans whose wall clocks ARE the ``GenResult``
timings; each span ends after a host sync (the sampled tokens are copied
to the host inside it), so on the card it times the device work, not its
enqueue.

Prompts are (B, S) or, for a K-codebook model, (B, S, K); an image-
prefix model takes ``image_embeds`` (B, n_img, D), and its positions
start after the prefix, as JAX's.  Sampling is greedy by default;
``greedy=False`` draws each token from ``softmax(logits)`` with a
``torch.Generator`` on the engine's device, seeded from ``seed`` and the
step (JAX folds its key per step; the draws cannot equal JAX's PRNG).
A codebook model takes the argmax per codebook either way, as JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SlotSpec
from repro_torch.models import model as M
from repro_torch.models.attention import _window_for
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer


def _pad_to(x, size: int, axis: int):
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def place_prefill_cache(cfg: ModelConfig, caches, s_max: int, prompt_len: int,
                        *, ring: bool = True):
    """Fit the prefill caches (length = prompt_len) into the allocated
    buffers, cast to bf16: pad linear caches to s_max; fold SWA caches into
    their ring; a Mamba slot's state and conv tail, which have no sequence
    axis, are only cast.  ``ring=False`` keeps every cache linear
    (position i at slot i) — the layout the paged KV cache pages in
    fixed-size blocks."""

    def place_slot(slot: SlotSpec, cache):
        if slot.mixer == "mamba":
            return {name: arr.to(torch.bfloat16)
                    for name, arr in cache.items()}
        window = _window_for(cfg, slot.mixer)
        use_ring = ring and bool(window) and window < s_max
        out = {}
        for name, arr in cache.items():  # arr (cycles, B, S, ...)
            arr = arr.to(torch.bfloat16)
            if not use_ring:
                out[name] = _pad_to(arr, s_max, axis=2)
                continue
            size = min(s_max, window)
            buf = arr.new_zeros(arr.shape[:2] + (size,) + arr.shape[3:])
            n = min(prompt_len, size)
            positions = torch.arange(prompt_len - n, prompt_len,
                                     device=arr.device)
            buf[:, :, positions % size] = arr[:, :, positions]
            out[name] = buf
        return out

    placed = {"slots": {f"slot{i}": place_slot(slot,
                                               caches["slots"][f"slot{i}"])
                        for i, slot in enumerate(cfg.pattern)}}
    if cfg.first_k_dense:
        placed["prelude"] = place_slot(M.prelude_slot(cfg), caches["prelude"])
    return placed


def greedy(logits: torch.Tensor, metrics: MetricsRegistry) -> np.ndarray:
    """Argmax over the vocab, copied to the host (the span-ending sync).
    Rows whose logits hold a NaN or inf are counted in the same copy, as
    ``serve/nonfinite_logit_rows``.  logits (B, V) -> (B,), or (B, K, V)
    -> (B, K)."""
    return _to_host(torch.argmax(logits, dim=-1), logits, metrics)


def sample(logits: torch.Tensor, metrics: MetricsRegistry,
           generator: Optional[torch.Generator] = None) -> np.ndarray:
    """:func:`greedy` without a generator; with one, a draw from
    ``softmax(logits)`` (fp32) per row, for (B, V) logits only.  A NaN
    logit has probability 0; a row with no finite logit draws token 0
    (it is counted as non-finite either way)."""
    if generator is None or logits.dim() > 2:
        return greedy(logits, metrics)
    lg = torch.nan_to_num(logits.float(), nan=float("-inf"))
    probs = torch.softmax(lg, dim=-1).nan_to_num(0.0)
    probs[:, 0] += (probs.sum(dim=-1) == 0).float()
    ids = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return _to_host(ids, logits, metrics)


def _to_host(ids: torch.Tensor, logits: torch.Tensor,
             metrics: MetricsRegistry) -> np.ndarray:
    bad = (~torch.isfinite(logits)).flatten(1).any(dim=1)
    n = ids.numel()
    host = torch.cat([ids.reshape(-1).to(torch.int32),
                      bad.to(torch.int32)]).cpu().numpy()
    metrics.inc("serve/nonfinite_logit_rows", int(host[n:].sum()))
    return host[:n].reshape(tuple(ids.shape))


def step_seed(seed: int, step: int) -> int:
    """The sampling generator's seed at ``step`` (0: the prefill's token):
    ``seed`` folded with the step, as JAX folds its key."""
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63)


@dataclass
class GenResult:
    tokens: np.ndarray  # (B, n_new[, K])
    prefill_s: float
    decode_s: float
    tokens_per_s: float

    def stats(self) -> Dict[str, float]:
        """Measured serving numbers for a report."""
        return {"batch": int(self.tokens.shape[0]),
                "n_new": int(self.tokens.shape[1]),
                "prefill_s": float(self.prefill_s),
                "decode_s": float(self.decode_s),
                "tokens_per_s": float(self.tokens_per_s)}


class Engine:
    def __init__(self, cfg: ModelConfig, run: RunConfig, params=None, *,
                 s_max: int = 512, seed: int = 0, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.run = run
        self.s_max = s_max
        self.device = resolve_device(device)
        # GenResult timings come FROM the tracer's spans, so the engine
        # always times against an *enabled* tracer
        self.tracer = (tracer if tracer is not None and tracer.enabled
                       else Tracer(enabled=True))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if params is None:
            params = M.init_params(cfg, seed, self.device)
        self.params = M.cast_params(params, cfg)

    def generate(self, prompts: np.ndarray, n_new: int, *,
                 greedy: bool = True,
                 lengths: Optional[np.ndarray] = None,
                 image_embeds: Optional[np.ndarray] = None,
                 seed: int = 0) -> GenResult:
        """prompts (B, S_prompt[, K]) right-padded; lengths (B,) true lens;
        image_embeds (B, n_img, D) before each prompt.  ``greedy=False``
        samples (module docstring)."""
        cfg, dev = self.cfg, self.device
        B, S_prompt = prompts.shape[:2]
        if lengths is None:
            lengths = np.full((B,), S_prompt, np.int32)
        n_img = cfg.num_image_tokens if image_embeds is not None else 0
        gen = None
        if not greedy:
            gen = torch.Generator(device=dev)

        def pick(logits, step):
            if gen is not None:
                gen.manual_seed(step_seed(seed, step))
            return sample(logits, self.metrics, gen)

        with self.tracer.span("prefill", batch=B, prompt_len=S_prompt) as sp_p:
            batch = {"tokens": torch.as_tensor(prompts, device=dev)}
            if image_embeds is not None:
                batch["image_embeds"] = torch.as_tensor(image_embeds,
                                                        device=dev)
            logits, caches, _ = M.forward(self.params, batch, cfg, self.run,
                                          with_cache=True)
            caches = place_prefill_cache(cfg, caches, self.s_max,
                                         S_prompt + n_img)
            # next-token logits at each example's true last position
            idx = torch.as_tensor(lengths - 1 + n_img, device=dev,
                                  dtype=torch.long)
            tok = pick(logits[torch.arange(B, device=dev), idx], 0)
        t_prefill = sp_p.elapsed_s

        pos = torch.as_tensor(lengths + n_img, dtype=torch.int32, device=dev)
        out = [tok]
        with self.tracer.span("decode", batch=B, n_new=n_new) as sp_d:
            for i in range(n_new - 1):
                tk = torch.as_tensor(tok, device=dev)[:, None]
                logits, caches = M.decode_step(self.params, tk, pos, caches,
                                               cfg, self.run, self.s_max)
                tok = pick(logits[:, -1], i + 1)
                out.append(tok)
                pos = pos + 1
        t_decode = sp_d.elapsed_s
        tokens = np.stack(out, axis=1)
        tps = B * n_new / max(t_prefill + t_decode, 1e-9)
        m = self.metrics
        m.observe("serve/prefill_s", t_prefill)
        m.observe("serve/decode_s", t_decode)
        if n_new > 1:
            m.observe("serve/decode_token_s", t_decode / (n_new - 1))
        m.inc("serve/tokens", B * n_new)
        # decode *work* performed: every row runs n_new token steps whether
        # the request wanted them or not
        m.inc("serve/decode_token_steps", B * n_new)
        m.inc("serve/generate_calls")
        m.set_gauge("serve/tokens_per_s", tps)
        return GenResult(tokens, t_prefill, t_decode, tps)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    n_new: int


class BatchScheduler:
    """Groups pending requests into fixed-size batches (padding ragged
    prompts) and runs them through one Engine."""

    def __init__(self, engine: Engine, max_batch: int = 8):
        self.engine = engine
        self.max_batch = max_batch
        self.pending: List[Request] = []
        self._next_id = 0
        self.history: List[GenResult] = []  # per-batch stats of the last run()
        self.stats: Dict[str, Any] = {}  # decode-work accounting of last run()
        self.latencies: Dict[int, float] = {}  # rid -> completion latency [s]

    def submit(self, prompt: np.ndarray, n_new: int) -> int:
        rid = self._next_id
        self._next_id += 1
        self.pending.append(Request(rid, prompt, n_new))
        return rid

    def run(self) -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        self.history = []
        self.latencies = {}
        m = self.engine.metrics
        tracer = self.engine.tracer
        b_idx = 0
        t_run = 0.0  # cumulative batch wall — each batch waits on the prior
        computed = delivered = engine_steps = 0
        while self.pending:
            m.observe("serve/queue_depth", len(self.pending))
            batch = self.pending[: self.max_batch]
            self.pending = self.pending[self.max_batch:]
            max_len = max(r.prompt.shape[0] for r in batch)
            n_new = max(r.n_new for r in batch)
            k = self.engine.cfg.num_codebooks
            shape = (len(batch), max_len) + ((k,) if k else ())
            prompts = np.zeros(shape, np.int32)
            lengths = np.zeros((len(batch),), np.int32)
            for i, r in enumerate(batch):
                prompts[i, : r.prompt.shape[0]] = r.prompt
                lengths[i] = r.prompt.shape[0]
            with tracer.span("serve_batch", batch_index=b_idx,
                             size=len(batch)):
                res = self.engine.generate(prompts, n_new, lengths=lengths)
            b_idx += 1
            m.observe("serve/batch_size", len(batch))
            m.inc("serve/requests", len(batch))
            self.history.append(res)
            t_run += res.prefill_s + res.decode_s
            computed += len(batch) * n_new
            delivered += sum(r.n_new for r in batch)
            engine_steps += n_new
            for i, r in enumerate(batch):
                results[r.rid] = res.tokens[i, : r.n_new]
                self.latencies[r.rid] = t_run  # whole batch retires together
        wasted = computed - delivered
        m.inc("serve/wasted_decode_steps", wasted)
        self.stats = {"decode_token_steps": computed,
                      "delivered_tokens": delivered,
                      "wasted_decode_steps": wasted,
                      "engine_steps": engine_steps}
        return results
