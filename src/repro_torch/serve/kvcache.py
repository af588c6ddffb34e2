"""Paged KV cache (the port of ``repro.serve.kvcache``): fixed-size
blocks, per-request block tables, free-list allocation, refcounted prefix
sharing.

Every sequence-cache leaf (``kv_seq`` axis in ``model.cache_specs``) is
stored as fixed-size blocks in a preallocated pool, one pool per leaf, and
a request owns an ordered *block table* of pool indices.  Leaves without a
sequence axis — a Mamba slot's recurrent state and conv tail — have a
size that does not grow with the request, and are kept whole, per
request, as bf16 device tensors.  A config with no sequence leaves
(mamba2) uses no block: it admits whatever fits a row, and publishes no
prefix (JAX's publish loop indexes the empty table there and raises once
a prompt reaches ``block_size``: ROADMAP, faults in the reference).

Unlike the JAX package, whose pools are host numpy, the pools here are
device tensors: at full width a host pool would send the whole working
cache over PCIe at every admission (4 rows x 512 positions x 80 KiB of KV
per token for granite-3-2b is ~168 MB).  ``write_prefill``,
``commit_token`` and ``gather_batch`` are device indexing; the block
tables and allocator stay on the host.  The values stored are the same
bf16 values.

Prefix sharing: a *full* block whose cumulative token prefix matches a
published block is reference-counted instead of copied.  Shared blocks are
never written — decode positions land past the prompt, and a block is only
published once every one of its ``block_size`` positions was written by the
prompt, so a block is either fully-written-and-shareable or private.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device, tree_items

SEQ_AXIS = 2  # (cycles, batch, kv_seq, *tail) in every sequence-cache leaf


class BlockAllocator:
    """Free-list block allocator with refcounted prefix sharing.

    Invariants: every block is free or allocated, never both; ``free`` of
    an unallocated block raises; a shared block survives until its last
    owner releases it; free + used always equals ``n_blocks``.
    """

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._key_to_bid: Dict[Any, int] = {}
        self._bid_to_key: Dict[int, Any] = {}
        self.peak_used = 0
        self.shared_hits = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        bid = self._free.pop()
        self._refs[bid] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return bid

    def share(self, key) -> Optional[int]:
        """Take another reference on the published block for ``key``."""
        bid = self._key_to_bid.get(key)
        if bid is None:
            return None
        self._refs[bid] += 1
        self.shared_hits += 1
        return bid

    def lookup(self, key) -> Optional[int]:
        return self._key_to_bid.get(key)

    def publish(self, bid: int, key) -> None:
        """Register a fully-written block under its token-prefix key."""
        if bid not in self._refs:
            raise RuntimeError(f"publish of unallocated block {bid}")
        if key in self._key_to_bid:
            return  # first writer wins; the copy stays private
        self._key_to_bid[key] = bid
        self._bid_to_key[bid] = key

    def free(self, bid: int) -> None:
        refs = self._refs.get(bid)
        if refs is None:
            raise RuntimeError(f"double free of block {bid}")
        if refs > 1:
            self._refs[bid] = refs - 1
            return
        del self._refs[bid]
        key = self._bid_to_key.pop(bid, None)
        if key is not None:
            del self._key_to_bid[key]
        self._free.append(bid)

    def refcount(self, bid: int) -> int:
        return self._refs.get(bid, 0)


def _token_key(tokens) -> Tuple:
    """A prompt as a tuple of positions: ints for (L,) tokens, K-tuples for
    a K-codebook prompt (L, K), so a block's prefix key covers whole
    positions.  JAX flattens (L, K) into L * K ints, whose prefix of a
    block's length covers only 1/K of its positions (ROADMAP, faults in
    the reference); for (L,) prompts both are the same."""
    arr = np.asarray(tokens)
    if arr.ndim == 2:
        return tuple(tuple(int(t) for t in row) for row in arr)
    return tuple(int(t) for t in arr.reshape(-1))


def _leaf(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class PagedKVCache:
    """Block-pooled device storage for every sequence-cache leaf of one
    model config: pool shape (n_blocks, cycles, block_size, *tail), bf16;
    each request's non-sequence leaves (Mamba state and conv) whole, at
    their (cycles, *tail) shape, bf16.  One BlockAllocator governs all
    pools — the leaves of one request's logical block i share a block
    id."""

    def __init__(self, cfg: ModelConfig, *, block_size: int, n_blocks: int,
                 s_max: int, device="cuda"):
        self.cfg = cfg
        self.block_size = int(block_size)
        self.s_max = int(s_max)
        self.device = resolve_device(device)
        self.alloc = BlockAllocator(n_blocks, block_size)

        self._seq_paths: List[Tuple[str, ...]] = []
        self._state_paths: List[Tuple[str, ...]] = []
        self._state_shapes: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        self._pools: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path, spec in tree_items(M.cache_specs(cfg, batch=1, s_max=s_max)):
            if not (len(spec.axes) > SEQ_AXIS and spec.axes[SEQ_AXIS] == "kv_seq"):
                self._state_paths.append(path)
                self._state_shapes[path] = (spec.shape[0],) + tuple(
                    spec.shape[2:])  # (cycles, *tail)
                continue
            self._seq_paths.append(path)
            cycles, tail = spec.shape[0], tuple(spec.shape[SEQ_AXIS + 1:])
            self._pools[path] = torch.zeros(
                (n_blocks, cycles, block_size) + tail, dtype=torch.bfloat16,
                device=self.device)

        self._tables: Dict[int, List[int]] = {}
        self._private: Dict[int, List[bool]] = {}
        self._tokens: Dict[int, Tuple[int, ...]] = {}
        self._lengths: Dict[int, int] = {}
        self._states: Dict[int, Dict[Tuple[str, ...], torch.Tensor]] = {}

    # -- admission ----------------------------------------------------------

    def blocks_for(self, total_len: int) -> int:
        return -(-int(total_len) // self.block_size)

    def _share_keys(self, tokens: Tuple[int, ...], total_len: int):
        """Per logical block: the prefix key if the block is fully covered
        by the prompt (shareable), else None."""
        keys = []
        for i in range(self.blocks_for(total_len)):
            end = (i + 1) * self.block_size
            keys.append(tokens[:end] if end <= len(tokens) else None)
        return keys

    def can_admit(self, tokens: np.ndarray, total_len: int) -> bool:
        if not self._seq_paths:
            return True  # recurrent state only: no block to reserve
        toks = _token_key(tokens)
        need = sum(1 for k in self._share_keys(toks, total_len)
                   if k is None or self.alloc.lookup(k) is None)
        return self.alloc.can_alloc(need)

    def admit(self, rid: int, tokens: np.ndarray, total_len: int) -> None:
        """Reserve the request's whole block table (prompt + all decode
        positions) up front — admitted requests can never OOM mid-flight."""
        toks = _token_key(tokens)
        table: List[int] = []
        private: List[bool] = []
        try:
            for key in (self._share_keys(toks, total_len)
                        if self._seq_paths else []):
                bid = self.alloc.share(key) if key is not None else None
                if bid is None:
                    bid = self.alloc.alloc()
                    private.append(True)
                else:
                    private.append(False)
                table.append(bid)
        except RuntimeError:
            for bid in table:
                self.alloc.free(bid)
            raise
        self._tables[rid] = table
        self._private[rid] = private
        self._tokens[rid] = toks
        self._lengths[rid] = 0
        self._states[rid] = {}

    def release(self, rid: int) -> None:
        for bid in self._tables.pop(rid):
            self.alloc.free(bid)
        self._private.pop(rid)
        self._tokens.pop(rid)
        self._lengths.pop(rid)
        self._states.pop(rid)

    # -- writes -------------------------------------------------------------

    def write_prefill(self, rid: int, caches, prompt_len: int) -> None:
        """Copy a single-request (B=1, linear, length>=prompt_len) cache
        tree into the pools and the request's state leaves; publish full
        private prompt blocks for prefix sharing.  Shared blocks already
        hold identical content — skipped."""
        table, private = self._tables[rid], self._private[rid]
        bs = self.block_size
        for path in self._seq_paths:
            arr = _leaf(caches, path)  # (cycles, 1, S, *tail)
            pool = self._pools[path]
            for i in range(self.blocks_for(prompt_len)):
                if not private[i]:
                    continue
                lo, hi = i * bs, min((i + 1) * bs, prompt_len)
                pool[table[i], :, : hi - lo] = arr[:, 0, lo:hi]
        for path in self._state_paths:
            self._states[rid][path] = _leaf(caches, path)[:, 0].to(
                device=self.device, dtype=torch.bfloat16, copy=True)
        toks = self._tokens[rid]
        for i in range(prompt_len // bs if self._seq_paths else 0):
            if private[i] and (i + 1) * bs <= len(toks):
                self.alloc.publish(table[i], toks[: (i + 1) * bs])
        self._lengths[rid] = prompt_len

    def commit_token(self, rids: List[int], rows: List[int], positions,
                     caches) -> None:
        """After one decode step, persist each live row's newly written
        cache entry (sequence position ``positions[j]``) from the working
        batch cache into the pools, one gather and one scatter per leaf,
        and its whole state leaves, rounded to bf16 (JAX rounds them when
        it next gathers: the same values)."""
        if not rids:
            return
        bs = self.block_size
        pos = np.asarray(positions, np.int64)
        dev = self.device
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        if self._seq_paths:
            pos_t = torch.as_tensor(pos, device=dev)
            bids = torch.as_tensor([self._tables[rid][int(p) // bs]
                                    for rid, p in zip(rids, pos)], device=dev)
            offs = torch.as_tensor(pos % bs, device=dev)
        for path in self._seq_paths:
            vals = _leaf(caches, path)[:, rows_t, pos_t]  # (cycles, n, *tail)
            pool = self._pools[path]
            pool[bids, :, offs] = vals.transpose(0, 1).to(pool.dtype)
        for path in self._state_paths:
            vals = _leaf(caches, path)[:, rows_t].to(torch.bfloat16)
            for j, rid in enumerate(rids):
                self._states[rid][path] = vals[:, j]
        for j, rid in enumerate(rids):
            self._lengths[rid] = max(self._lengths[rid], int(pos[j]) + 1)

    # -- reads --------------------------------------------------------------

    def gather_batch(self, row_rids: List[Optional[int]]):
        """Reconstruct a (cycles, len(rows), s_max, *tail) working cache
        tree from the pools — rows with ``None`` zero-filled, positions past
        a row's length zero — and each row's state leaves, (cycles,
        len(rows), *tail), zero for a free row.  The pools are the source
        of truth: this is
        the only way cache state enters the decode step after an admission
        reshuffles rows."""
        B = len(row_rids)
        out: Dict[str, Any] = {}
        for path in self._seq_paths:
            pool = self._pools[path]
            cycles, tail = pool.shape[1], tuple(pool.shape[3:])
            buf = pool.new_zeros((cycles, B, self.s_max) + tail)
            for row, rid in enumerate(row_rids):
                if rid is None:
                    continue
                n = self._lengths[rid]
                nb = self.blocks_for(n)
                ids = torch.as_tensor(self._tables[rid][:nb], device=self.device)
                blocks = pool[ids].transpose(0, 1)  # (cycles, nb, bs, *tail)
                buf[:, row, :n] = blocks.reshape(
                    (cycles, nb * self.block_size) + tail)[:, :n]
            _put(out, path, buf)
        for path in self._state_paths:
            shape = self._state_shapes[path]
            buf = torch.zeros((shape[0], B) + shape[1:], dtype=torch.bfloat16,
                              device=self.device)
            for row, rid in enumerate(row_rids):
                if rid is not None and path in self._states[rid]:
                    buf[:, row] = self._states[rid][path]
            _put(out, path, buf)
        return out

    def stats(self) -> Dict[str, Any]:
        bytes_per_block = int(sum(
            p.shape[1] * int(np.prod(p.shape[2:])) * p.element_size()
            for p in self._pools.values()))
        return {"block_size": self.block_size,
                "n_blocks": self.alloc.n_blocks,
                "used_blocks": self.alloc.n_used,
                "peak_blocks": self.alloc.peak_used,
                "peak_occupancy": (self.alloc.peak_used / self.alloc.n_blocks
                                   if self.alloc.n_blocks else 0.0),
                "shared_block_hits": self.alloc.shared_hits,
                "block_bytes": bytes_per_block}
