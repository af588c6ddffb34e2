"""Crash-safe checkpointing (the port of ``repro.checkpoint.io``), in the
JAX package's on-disk format, so a checkpoint written by either package
restores into the other.

One ``step_%08d.npz`` + one ``step_%08d.meta.json`` per step, plus a
top-level ``manifest.json`` pointing at the newest complete step.  A tree
is a nested dict of tensors (or Python ints, as the optimizer's step);
its leaves are stored under their ``/``-joined path strings
(``params/slots/slot0/mixer/wq``, ``opt_state/m/...``,
``opt_state/step``), the names ``jax.tree_util`` gives the same dict.
The on-disk layout is purely logical (path-keyed arrays + their true
dtypes), so the same checkpoint restores onto any device or data-parallel
width whose logical tree matches (elastic resume).

Atomicity protocol (every write in this module follows it):

1. write the payload to ``<name>.tmp.<pid>`` in the same directory,
2. ``os.replace`` it over the final name — atomic on POSIX, so a crash
   mid-write leaves only a dead tmp file, never a torn checkpoint;
3. the step's ``.meta.json`` is replaced only *after* its ``.npz``, and
   ``manifest.json`` only after both — readers that follow
   :func:`latest_step` can therefore never observe a partial step;
4. the manifest is step-monotonic: a slow (async) save of step N that
   finishes after step N+1's save must not move the pointer backwards.

Dtypes as JAX stores them: bfloat16 (which numpy lacks) is stored as a
``uint16`` view of its bits with ``"dtype": "bfloat16"`` in the step's
meta, converted with ``Tensor.view`` (no ``ml_dtypes``); a Python int leaf
is a 0-d ``int32`` array, as JAX's ``init_state`` makes the optimizer's
step, and comes back as an int.

Async saves live in :class:`repro_torch.checkpoint.manager.
CheckpointManager`; the functions here are synchronous primitives.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import path_str, tree_items, tree_unflatten
from repro_torch.obs.trace import monotonic

MANIFEST_SCHEMA_ID = "repro.checkpoint/manifest/v1"

# dtypes numpy lacks, stored as a same-width unsigned-int view of the bits
_BITS_VIEW = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16)}
_BY_NAME = {name: (dt, view) for dt, (name, _, view) in _BITS_VIEW.items()}


def validate_manifest(d: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ValueError unless ``d`` is a valid ``MANIFEST_SCHEMA_ID``
    payload; returns it.  The id covers both on-disk JSON shapes: the
    top-level ``manifest.json`` pointer (``keys`` + ``written_s``) and a
    step's ``.meta.json`` (per-key ``layout``)."""
    if not isinstance(d, dict):
        raise ValueError(f"manifest must be a dict, got {type(d).__name__}")
    if d.get("schema") != MANIFEST_SCHEMA_ID:
        raise ValueError(f"manifest schema {d.get('schema')!r} != "
                         f"{MANIFEST_SCHEMA_ID!r}")
    step = d.get("step")
    if not isinstance(step, int) or step < 0:
        raise ValueError(f"manifest step must be an int >= 0, got {step!r}")
    if "layout" in d:
        if not isinstance(d["layout"], dict):
            raise ValueError("meta layout must be a dict")
        for key, entry in d["layout"].items():
            for want in ("shape", "dtype", "stored_dtype"):
                if want not in entry:
                    raise ValueError(f"layout[{key!r}] missing {want!r}")
    elif "keys" in d:
        keys = d["keys"]
        if (not isinstance(keys, list)
                or any(not isinstance(k, str) for k in keys)):
            raise ValueError("manifest keys must be a list of strings")
    else:
        raise ValueError("manifest payload has neither 'keys' (pointer) "
                         "nor 'layout' (step meta)")
    return d


def _step_npz(d: Path, step: int) -> Path:
    return d / f"step_{step:08d}.npz"


def _step_meta(d: Path, step: int) -> Path:
    return d / f"step_{step:08d}.meta.json"


def _host(leaf, copy: bool) -> Tuple[np.ndarray, str]:
    """(storable numpy array, true dtype name) of one leaf: a tensor or a
    Python int.  A tensor off the CPU is copied to the host (the copy a
    save pays on a card); a CPU tensor shares its storage unless
    ``copy``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        elif copy:
            t = t.clone()
        if t.dtype in _BITS_VIEW:
            name, uint, view = _BITS_VIEW[t.dtype]
            return t.view(view).numpy().view(uint), name
        arr = t.numpy()
        return arr, arr.dtype.name
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"  # JAX's optimizer step
    raise TypeError(f"checkpoint leaf of type {type(leaf).__name__} is not "
                    "a tensor or an int")


def _flatten(tree, copy: bool = False) -> Dict[str, Tuple[np.ndarray, str]]:
    """{path string: (stored array, true dtype name)} in JAX's flatten
    order (sorted keys)."""
    return {path_str(p): _host(leaf, copy) for p, leaf in tree_items(tree)}


def _atomic_write_manifest(d: Path, step: int, keys, written_s: float):
    """Move the latest-step pointer forward — never backward: a slow async
    save of step N landing after step N+1 must not clobber the newer
    manifest.  tmp + ``os.replace`` keeps the pointer itself untearable."""
    path = d / "manifest.json"
    if path.exists():
        try:
            prev = json.loads(path.read_text())
        except (OSError, ValueError):
            prev = {}
        if int(prev.get("step", -1)) >= step:
            return
    manifest = {
        "schema": MANIFEST_SCHEMA_ID,
        "step": step,
        "keys": sorted(keys),
        "written_s": round(written_s, 3),
    }
    tmp = d / f"manifest.json.tmp.{os.getpid()}"
    tmp.write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, path)


def _write_step(d: Path, step: int,
                flat: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """One complete step: npz (bit-pattern views), then its meta (logical
    layout), then the manifest pointer — each atomically, in that order."""
    t0 = monotonic()
    stored: Dict[str, np.ndarray] = {}
    layout: Dict[str, Dict[str, Any]] = {}
    for key, (arr, true_dtype) in flat.items():
        stored[key] = arr
        layout[key] = {"shape": list(arr.shape), "dtype": true_dtype,
                       "stored_dtype": arr.dtype.name}
    npz = _step_npz(d, step)
    tmp = npz.with_suffix(f".npz.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **stored)
    os.replace(tmp, npz)
    meta = {"schema": MANIFEST_SCHEMA_ID, "step": step, "layout": layout}
    mtmp = _step_meta(d, step).with_suffix(f".json.tmp.{os.getpid()}")
    mtmp.write_text(json.dumps(meta, indent=1))
    os.replace(mtmp, _step_meta(d, step))
    _atomic_write_manifest(d, step, flat.keys(), monotonic() - t0)


def save(tree, directory: str, step: int) -> None:
    """Blocking atomic save of ``tree`` as checkpoint ``step``.  Use
    :class:`repro_torch.checkpoint.manager.CheckpointManager` for
    serialized async saves with ``wait()``."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    _write_step(d, int(step), _flatten(tree))


def _complete_steps(d: Path):
    """Steps whose npz AND meta both exist, ascending — the only states a
    reader may observe as restorable."""
    steps = []
    for p in sorted(d.glob("step_*.npz")):
        try:
            step = int(p.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if _step_meta(d, step).exists():
            steps.append(step)
    return steps


def latest_step(directory: str) -> Optional[int]:
    """Newest *complete* step, or None.  The manifest pointer is only
    trusted when its step's files actually exist — a crash between the
    npz landing and the manifest moving (or a deleted step) falls back to
    a directory scan for the last valid step."""
    d = Path(directory)
    manifest = d / "manifest.json"
    if manifest.exists():
        try:
            step = int(json.loads(manifest.read_text())["step"])
        except (OSError, ValueError, KeyError):
            step = None
        if step is not None and _step_npz(d, step).exists() \
                and _step_meta(d, step).exists():
            return step
    steps = _complete_steps(d)
    return steps[-1] if steps else None


def _read(directory: str, step: Optional[int], keys: Iterable[str]):
    """(step, layout, open npz) of a complete checkpoint step (the newest
    when None) whose key set is exactly ``keys``; a mismatch raises one
    ValueError naming every missing and extra key."""
    d = Path(directory)
    step = latest_step(directory) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    npz = _step_npz(d, step)
    if not npz.exists() or not _step_meta(d, step).exists():
        raise FileNotFoundError(f"checkpoint step {step} incomplete in "
                                f"{directory} (npz or meta missing)")
    layout = json.loads(_step_meta(d, step).read_text()).get("layout", {})
    data = np.load(npz)
    keys = set(keys)
    missing = sorted(keys - set(data.files))
    extra = sorted(set(data.files) - keys)
    if missing or extra:
        data.close()
        raise ValueError(
            f"checkpoint step {step} in {directory} does not match the "
            f"template tree: missing from checkpoint {missing or '[]'}; "
            f"extra in checkpoint {extra or '[]'}")
    return step, layout, data


def _tensor(arr: np.ndarray, entry: Optional[Dict[str, Any]]) -> torch.Tensor:
    """A stored array as a CPU tensor of its true dtype."""
    if entry and entry["dtype"] in _BY_NAME:
        dt, view = _BY_NAME[entry["dtype"]]
        return torch.from_numpy(arr).view(view).view(dt)
    return torch.from_numpy(arr)


def restore(template, directory: str, step: Optional[int] = None):
    """Restore into the structure of ``template`` (a nested dict of tensors
    or ints).  Returns ``(tree, step)``: a tensor leaf comes back as a new
    tensor on the template leaf's device with the stored dtype, an int
    leaf as an int.  Key-set mismatches between the checkpoint and the
    template raise a single ``ValueError`` listing every missing and extra
    key."""
    items = list(tree_items(template))
    step, layout, data = _read(directory, step,
                               (path_str(p) for p, _ in items))
    out = []
    with data:
        for path, leaf in items:
            key = path_str(path)
            t = _tensor(data[key], layout.get(key))
            if isinstance(leaf, torch.Tensor):
                out.append((path, t.to(leaf.device)))
            else:
                out.append((path, int(t)))
    return tree_unflatten(out), step


def restore_into(trees: List[dict], directory: str,
                 step: Optional[int] = None) -> int:
    """Copy checkpoint ``step`` (the newest when None) into every tree of
    ``trees`` (replicas of one logical tree, on any devices), reading each
    array once: a tensor leaf is overwritten in place and must have the
    stored shape and dtype; an int leaf is replaced in its dict.  Keys are
    checked as :func:`restore` checks them.  Returns the step."""
    items = [list(tree_items(t)) for t in trees]
    step, layout, data = _read(directory, step,
                               (path_str(p) for p, _ in items[0]))
    with data, torch.no_grad():
        for j, (path, _) in enumerate(items[0]):
            key = path_str(path)
            t = _tensor(data[key], layout.get(key))
            for tree, leaves in zip(trees, items):
                leaf = leaves[j][1]
                if not isinstance(leaf, torch.Tensor):
                    node = tree
                    for k in path[:-1]:
                        node = node[k]
                    node[path[-1]] = int(t)
                elif leaf.shape != t.shape or leaf.dtype != t.dtype:
                    raise ValueError(
                        f"checkpoint step {step} {key}: stored "
                        f"{tuple(t.shape)} {t.dtype}, the tree holds "
                        f"{tuple(leaf.shape)} {leaf.dtype}")
                else:
                    leaf.copy_(t)
    return step
