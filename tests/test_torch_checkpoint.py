"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): the io primitives and the atomicity
protocol (each test the twin of one in tests/test_checkpoint.py), the
on-disk format both ways (a checkpoint written by either package
restores into the other with the same keys, dtypes and bits), and
auto-resume in the loop, in the threaded trainer onto another dp, and in
one-rank trainers (threads on a shared ``HashStore``; no test here starts
a process).

Sizes are tests/test_checkpoint.py's ``tiny_cfg()``; fp32 tolerance 2e-4
(tests/test_kernels.py) where the two packages run the same training
steps, 1e-6 where one package resumes its own run (JAX's elastic test),
bitwise where the port resumes its own loop on the CPU.
"""
import json
import os
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import checkpoint as jckpt
from repro.configs.base import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models.blocks import RunConfig as JRun
from repro.optim import adamw as jopt
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Session
from repro_torch.checkpoint import (CheckpointManager, MANIFEST_SCHEMA_ID,
                                    latest_step, restore, restore_into, save,
                                    validate_manifest)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import tree_items
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import Tracer
from repro_torch.optim.adamw import OptConfig, init_state
from repro_torch.train import loop as tloop

TOL = 2e-4
TIMEOUT = timedelta(seconds=60)
JOIN_S = 120


def tiny_cfgs():
    """tests/test_checkpoint.py's tiny_cfg(), in both packages."""
    kw = dict(vocab_size=256, d_model=64, num_heads=2, num_kv_heads=1,
              head_dim=32, d_ff=128, dtype="float32")
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


def run_opt():
    return (RunConfig(attn_impl="dense", remat="none"),
            OptConfig(lr=1e-3, warmup_steps=0))


def jax_run_opt():
    return (JRun(attn_impl="dense", remat="none"),
            jopt.OptConfig(lr=1e-3, warmup_steps=0))


def _jax_params(jcfg, seed=0):
    """JAX's init as numpy (each package's run gets its own copy)."""
    return jax.tree_util.tree_map(np.asarray, jcommon.materialize(
        JM.model_specs(jcfg), jax.random.PRNGKey(seed)))


def _bits(a):
    """Raw bytes of a tensor or array, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# io primitives: dtypes, atomicity, manifest
# ---------------------------------------------------------------------------


def test_dtype_roundtrip_fp32_bf16_int(tmp_path):
    tree = {
        "w": torch.linspace(-1, 1, 12).reshape(3, 4),
        "b": torch.tensor([1.5, -2.25, 3e-2], dtype=torch.bfloat16),
        "step": torch.tensor([7], dtype=torch.int64),
        "mask": torch.tensor([1, 0, 1], dtype=torch.int32),
        "count": 5,  # a Python int, as the optimizer's step
    }
    save(tree, str(tmp_path), step=3)
    template = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                    else 0) for k, v in tree.items()}
    out, step = restore(template, str(tmp_path))
    assert step == 3
    for k in ("w", "b", "step", "mask"):
        assert out[k].dtype == tree[k].dtype, k
        # bit-exact, not allclose: bf16 goes through the uint16 view
        assert _bits(out[k]) == _bits(tree[k]), k
    assert out["count"] == 5 and isinstance(out["count"], int)

    # the step meta records the true dtype next to the stored bit-pattern
    meta = json.loads((tmp_path / "step_00000003.meta.json").read_text())
    validate_manifest(meta)
    assert meta["layout"]["b"]["dtype"] == "bfloat16"
    assert meta["layout"]["b"]["stored_dtype"] == "uint16"
    assert meta["layout"]["w"]["dtype"] == "float32"
    assert meta["layout"]["w"]["stored_dtype"] == "float32"
    assert meta["layout"]["count"] == {"shape": [], "dtype": "int32",
                                       "stored_dtype": "int32"}


def test_manifest_validates_and_rejects_drift(tmp_path):
    save({"x": torch.ones(2)}, str(tmp_path), step=1)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert validate_manifest(man)["step"] == 1
    assert man["schema"] == MANIFEST_SCHEMA_ID == jckpt.MANIFEST_SCHEMA_ID
    with pytest.raises(ValueError):
        validate_manifest({**man, "schema": "repro.checkpoint/manifest/v9"})
    with pytest.raises(ValueError):
        validate_manifest({**man, "step": -1})
    with pytest.raises(ValueError):
        validate_manifest({"schema": MANIFEST_SCHEMA_ID, "step": 0})


def test_crash_between_npz_and_meta_is_invisible(tmp_path):
    """A step whose meta never landed (crash mid-protocol) must be
    unobservable: latest_step skips it, restore refuses it."""
    save({"x": torch.full((3,), 1.0)}, str(tmp_path), step=1)
    np.savez(tmp_path / "step_00000002.npz", x=np.full(3, 2.0, np.float32))
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        restore({"x": torch.zeros(3)}, str(tmp_path), step=2)
    out, step = restore({"x": torch.zeros(3)}, str(tmp_path))
    assert step == 1 and float(out["x"][0]) == 1.0


def test_stale_manifest_falls_back_to_directory_scan(tmp_path):
    save({"x": torch.ones(2)}, str(tmp_path), step=1)
    save({"x": torch.full((2,), 2.0)}, str(tmp_path), step=2)
    os.remove(tmp_path / "step_00000002.npz")
    assert json.loads((tmp_path / "manifest.json").read_text())["step"] == 2
    assert latest_step(str(tmp_path)) == 1


def test_manifest_is_step_monotonic(tmp_path):
    """A slow save of an OLDER step landing after a newer one must not
    move the pointer backwards."""
    save({"x": torch.ones(2)}, str(tmp_path), step=5)
    ckpt_io._write_step(ckpt_io.Path(str(tmp_path)), 3,
                        ckpt_io._flatten({"x": torch.full((2,), 3.0)}))
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["step"] == 5
    assert latest_step(str(tmp_path)) == 5
    out, _ = restore({"x": torch.zeros(2)}, str(tmp_path), step=3)
    assert float(out["x"][0]) == 3.0


def test_restore_reports_missing_and_extra_keys(tmp_path):
    save({"a": torch.ones(2), "b": torch.ones(2)}, str(tmp_path), step=1)
    for fn in (lambda t: restore(t, str(tmp_path)),
               lambda t: restore_into([t], str(tmp_path))):
        with pytest.raises(ValueError) as e:
            fn({"a": torch.zeros(2), "c": torch.zeros(2)})
        msg = str(e.value)
        assert "'c'" in msg and "'b'" in msg  # one error names BOTH


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore({"x": torch.zeros(2)}, str(tmp_path))
    assert latest_step(str(tmp_path)) is None


def test_tmp_files_never_observable(tmp_path):
    save({"x": torch.ones(2)}, str(tmp_path), step=1)
    (tmp_path / "step_00000009.npz.tmp.12345").write_bytes(b"torn")
    (tmp_path / "manifest.json.tmp.12345").write_text("{")
    assert latest_step(str(tmp_path)) == 1


def test_restore_into_replicas_in_place(tmp_path):
    """restore_into reads each array once and overwrites every replica's
    tensors in place (the trainer keeps references to them); an int leaf
    is replaced in its dict; a shape or dtype that differs from the
    stored one raises."""
    save({"p": {"w": torch.arange(6.0).reshape(2, 3)}, "s": {"step": 4}},
         str(tmp_path), step=2)
    reps = [{"p": {"w": torch.zeros(2, 3)}, "s": {"step": 0}}
            for _ in range(3)]
    held = [r["p"]["w"] for r in reps]
    assert restore_into(reps, str(tmp_path)) == 2
    for r, w in zip(reps, held):
        assert r["p"]["w"] is w
        assert torch.equal(w, torch.arange(6.0).reshape(2, 3))
        assert r["s"]["step"] == 4
    with pytest.raises(ValueError, match="stored"):
        restore_into([{"p": {"w": torch.zeros(3, 2)}, "s": {"step": 0}}],
                     str(tmp_path))
    with pytest.raises(ValueError, match="stored"):
        restore_into([{"p": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                       "s": {"step": 0}}], str(tmp_path))
    with pytest.raises(TypeError, match="not a tensor or an int"):
        save({"x": object()}, str(tmp_path), step=3)


# ---------------------------------------------------------------------------
# CheckpointManager: serialized async saves
# ---------------------------------------------------------------------------


def test_async_saves_serialize_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in range(1, 6):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    assert mgr.latest_step() == 5
    out, step = mgr.restore({"x": torch.zeros(4)})
    assert step == 5 and float(out["x"][0]) == 5.0
    assert [int(p.stem.split("_")[1])
            for p in sorted(tmp_path.glob("step_*.npz"))] == [1, 2, 3, 4, 5]
    mgr.close()
    mgr.close()  # idempotent


def test_async_save_snapshots_at_enqueue(tmp_path):
    """The port's AdamW updates tensors in place, and a CPU tensor's
    .numpy() shares its storage: the snapshot taken at enqueue must be a
    copy, so an in-place add_ right after save() cannot reach the file.
    The writer is held back until after the add_, so the test does not
    depend on the writer's timing."""
    gate = threading.Event()
    tracer = Tracer(enabled=True)
    mgr = CheckpointManager(str(tmp_path), tracer)
    write = mgr._write

    def held(step, flat):
        assert gate.wait(JOIN_S)
        write(step, flat)

    mgr._write = held
    x = torch.full((4,), 1.0)
    mgr.save(1, {"x": x})
    x.add_(-100.0)
    gate.set()
    mgr.wait()
    out, _ = mgr.restore({"x": torch.zeros(4)})
    assert float(out["x"][0]) == 1.0
    mgr.close()
    assert [e.name for e in tracer.events()] == ["ckpt_enqueue",
                                                 "ckpt_write"]


def test_async_rejects_non_monotonic_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"x": torch.ones(2)})
    with pytest.raises(ValueError):
        mgr.save(4, {"x": torch.ones(2)})
    with pytest.raises(ValueError):
        mgr.save(2, {"x": torch.ones(2)})
    mgr.close()


def test_async_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A failure in the writer thread is re-raised by wait(), not
    swallowed."""

    def broken(d, step, flat):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io, "_write_step", broken)
    mgr = CheckpointManager(str(tmp_path / "sub"))
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError) as e:
        mgr.wait()
    assert isinstance(e.value.__cause__, OSError)
    mgr.close()


# ---------------------------------------------------------------------------
# One format: either package restores the other's checkpoint
# ---------------------------------------------------------------------------


def _format_trees():
    """The same logical tree in both packages: fp32 and bf16 leaves (the
    bf16 ones built from the same bits) and the optimizer's int32 step
    (a Python int in the port, a 0-d int32 array in JAX)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    m = rng.standard_normal((4,)).astype(np.float32)
    bits = torch.from_numpy(rng.standard_normal((2, 5)).astype(
        np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    jtree = {"params": {"emb": bits.view(ml_dtypes.bfloat16), "w": w},
             "opt_state": {"m": {"w": m}, "step": np.asarray(7, np.int32)}}
    ttree = {"params": {"emb": torch.from_numpy(bits.copy()).view(
                 torch.bfloat16), "w": torch.from_numpy(w.copy())},
             "opt_state": {"m": {"w": torch.from_numpy(m.copy())},
                           "step": 7}}
    return jtree, ttree


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else
                torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in tree.items()}


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jtree, ttree = _format_trees()
    jckpt.save(jtree, str(tmp_path), step=2)
    out, step = restore(_zeros_like(ttree), str(tmp_path))
    assert step == 2
    got, want = dict(tree_items(out)), dict(tree_items(ttree))
    assert set(got) == set(want)
    assert got[("opt_state", "step")] == 7
    for path, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[path].dtype == w.dtype, path
            assert _bits(got[path]) == _bits(w), path


def test_port_checkpoint_restores_into_jax(tmp_path):
    """Onto device arrays, as JAX's loop restores its state (a host numpy
    template would come back with the 0-d step as shape (1,): the JAX
    package's np.ascontiguousarray)."""
    jtree, ttree = _format_trees()
    save(ttree, str(tmp_path), step=2)
    template = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype), jtree)
    out, step = jckpt.restore(template, str(tmp_path))
    assert step == 2
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(out)[0]}
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert _bits(got[k]) == _bits(w), k
    assert out["opt_state"]["step"].dtype == jnp.int32
    assert int(out["opt_state"]["step"]) == 7


def test_both_packages_write_the_same_files(tmp_path):
    """The npz holds the same keys in the same order, dtypes and bits; the
    step meta is the same JSON; the manifest differs only in written_s."""
    jtree, ttree = _format_trees()
    jd, td = tmp_path / "jax", tmp_path / "port"
    jckpt.save(jtree, str(jd), step=2)
    save(ttree, str(td), step=2)
    with np.load(jd / "step_00000002.npz") as a, \
            np.load(td / "step_00000002.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    assert (json.loads((jd / "step_00000002.meta.json").read_text())
            == json.loads((td / "step_00000002.meta.json").read_text()))
    jm = json.loads((jd / "manifest.json").read_text())
    tm = json.loads((td / "manifest.json").read_text())
    jm.pop("written_s"), tm.pop("written_s")
    assert jm == tm


# ---------------------------------------------------------------------------
# Auto-resume: the loop, across packages, the trainers
# ---------------------------------------------------------------------------


def test_loop_resumes_bitwise(tmp_path):
    """Save every 2 steps, stop at 4, resume to 6: the resumed losses are
    the uninterrupted run's, bit for bit (the same ops on the same bits on
    the CPU), and the loop reports where it started."""
    _, tcfg = tiny_cfgs()
    run, opt = run_opt()
    kw = dict(batch=4, seq=16, seed=0, log_every=0, device="cpu")
    ck = str(tmp_path / "ck")
    ref = tloop.train(tcfg, run, opt, steps=6, **kw)
    r1 = tloop.train(tcfg, run, opt, steps=4, ckpt_dir=ck, ckpt_every=2,
                     **kw)
    assert r1.start_step == 0 and latest_step(ck) == 4
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.npz")) == [
        "step_00000002.npz", "step_00000004.npz"]
    r2 = tloop.train(tcfg, run, opt, steps=6, ckpt_dir=ck, ckpt_every=2,
                     **kw)
    assert r1.losses == ref.losses[:4]
    assert r2.start_step == 4 and r2.losses == ref.losses[4:]
    assert r2.summary()["start_step"] == 4 and latest_step(ck) == 6


def test_loop_refuses_a_pinned_step_it_cannot_read(tmp_path):
    """A rank told to resume from a step it cannot read raises; it never
    starts fresh."""
    _, tcfg = tiny_cfgs()
    run, opt = run_opt()
    with pytest.raises(FileNotFoundError):
        tloop.train(tcfg, run, opt, batch=2, seq=8, steps=3, device="cpu",
                    log_every=0, ckpt_dir=str(tmp_path), start_step=2)


def _jax_loop(jcfg, params, **kw):
    run, opt = jax_run_opt()
    return jloop.train(jcfg, run, opt, batch=4, seq=16, seed=0, log_every=0,
                       params=jax.tree_util.tree_map(jnp.asarray, params),
                       **kw).losses


def _port_loop(tcfg, params, **kw):
    run, opt = run_opt()
    return tloop.train(tcfg, run, opt, batch=4, seq=16, seed=0, log_every=0,
                       device="cpu", params=params_from_numpy(
                           params, tcfg, "cpu"), **kw).losses


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, writer):
    """One package's loop writes a checkpoint at step 2 and the other's
    resumes from it to step 4: the resumed losses continue the writer's
    uninterrupted run at fp32 2e-4 (the two packages' steps agree to that
    tolerance, tests/test_torch_train.py)."""
    jcfg, tcfg = tiny_cfgs()
    p0 = _jax_params(jcfg)
    ck = str(tmp_path / "ck")
    first, then = ((_jax_loop, jcfg), (_port_loop, tcfg))
    if writer == "port":
        first, then = then, first
    ref = first[0](first[1], p0, steps=4)
    head = first[0](first[1], p0, steps=2, ckpt_dir=ck, ckpt_every=2)
    assert latest_step(ck) == 2
    np.testing.assert_allclose(head, ref[:2], rtol=1e-6)
    tail = then[0](then[1], p0, steps=4, ckpt_dir=ck, ckpt_every=2)
    assert len(tail) == 2 and latest_step(ck) == 4
    np.testing.assert_allclose(tail, ref[2:], atol=TOL, rtol=TOL)


def moe_cfgs():
    """deepseek-v2's reduced config with one MLA + MoE cycle after its
    dense prelude layer, fp32, in both packages."""
    kw = dict(vocab_size=256, num_layers=2, dtype="float32")
    return (jax_get_config("deepseek-v2-236b").reduced().replace(**kw),
            get_config("deepseek-v2-236b").reduced().replace(**kw))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_prelude_checkpoint_across_packages(tmp_path, writer):
    """A deepseek-v2 checkpoint (prelude, MLA, router, routed and shared
    experts, the AdamW moments) written by one package restores in the
    other: every leaf of the port's tree is in it, and the reader's loop
    resumes the writer's run at fp32 2e-4."""
    jcfg, tcfg = moe_cfgs()
    p0 = _jax_params(jcfg)
    ck = str(tmp_path / "ck")
    first, then = ((_jax_loop, jcfg), (_port_loop, tcfg))
    if writer == "port":
        first, then = then, first
    ref = first[0](first[1], p0, steps=3)
    first[0](first[1], p0, steps=2, ckpt_dir=ck, ckpt_every=2)
    params = params_from_numpy(p0, tcfg, "cpu")
    template = {"params": params,
                "opt_state": init_state(run_opt()[1], params)}
    out, step = restore(_zeros_like(template), ck)  # raises on a missing key
    assert step == 2
    leaves = dict(tree_items(out["params"]))
    assert ("prelude", "mlp", "w_gate") in leaves
    assert ("slots", "slot0", "mlp", "router") in leaves
    assert ("slots", "slot0", "mlp", "shared", "w_up") in leaves
    tail = then[0](then[1], p0, steps=3, ckpt_dir=ck, ckpt_every=2)
    assert len(tail) == 1
    np.testing.assert_allclose(tail, ref[2:], atol=TOL, rtol=TOL)


def _trainer(dp, **kw):
    _, tcfg = tiny_cfgs()
    return DataParallelTrainer(tcfg, *run_opt(), devices=["cpu"] * dp,
                               group_timeout=TIMEOUT, **kw)


def _train(tr, **kw):
    try:
        return tr.train(batch=4, seq=16, seed=0, log_every=0, **kw)
    finally:
        tr.close()


def test_kill_and_resume_elastic_dp4_to_dp2(tmp_path):
    """The port of JAX's acceptance trajectory: the threaded dp = 4 trainer
    checkpoints every 2 steps and is stopped at 4; dp = 2 resumes the same
    directory and continues the uninterrupted dp = 4 losses at 1e-6."""
    ck = str(tmp_path / "ck")
    ref = _train(_trainer(4, strategy="all_reduce"), steps=6).losses
    r1 = _train(_trainer(4, strategy="all_reduce"), steps=4, ckpt_dir=ck,
                ckpt_every=2)
    assert r1.start_step == 0 and latest_step(ck) == 4
    tr = _trainer(2, strategy="all_reduce")
    r2 = _train(tr, steps=6, ckpt_dir=ck, ckpt_every=2)
    assert r2.start_step == 4 and len(r2.losses) == 2
    np.testing.assert_allclose(r2.losses, ref[4:], atol=1e-6)
    assert latest_step(ck) == 6
    # every replica got the checkpoint and stayed in step
    for (_, a), (_, b) in zip(tree_items(tr.params[0]),
                              tree_items(tr.params[1])):
        assert torch.equal(a, b)
    assert tr.opt_states[0]["step"] == tr.opt_states[1]["step"] == 6


def test_one_rank_trainers_resume_from_rank0_step(tmp_path, monkeypatch):
    """Two one-rank trainers (what each torchrun process builds) in threads
    on a shared HashStore: only rank 0 writes; both resume from the step
    rank 0 found and continue the threaded dp = 2 run bitwise."""
    ck = str(tmp_path / "ck")
    writers = []
    save_step = tloop.CheckpointManager.save

    def spy(mgr, step, tree, **kw):
        writers.append((threading.current_thread().name, step))
        return save_step(mgr, step, tree, **kw)

    monkeypatch.setattr(tloop.CheckpointManager, "save", spy)
    ref_tr = _trainer(2, strategy="all_reduce")
    ref = _train(ref_tr, steps=4)

    def job(steps):
        store = dist.HashStore()
        out, errors = [None] * 2, []

        def rank(r):
            try:
                _, tcfg = tiny_cfgs()
                tr = DataParallelTrainer(
                    tcfg, *run_opt(), strategy="all_reduce",
                    devices=["cpu"], rank=r, world=2, store=store,
                    group_timeout=TIMEOUT)
                out[r] = (_train(tr, steps=steps, ckpt_dir=ck, ckpt_every=2),
                          tr.params[0])
            except BaseException as e:  # surfaced in the test's thread
                errors.append(e)
                raise

        threads = [threading.Thread(target=rank, args=(r,), name=f"rank{r}")
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        if errors:
            raise errors[0]
        return out

    job(2)
    assert writers == [("rank0", 2)] and latest_step(ck) == 2
    out = job(4)
    assert writers == [("rank0", 2), ("rank0", 4)]
    for r, (res, params) in enumerate(out):
        assert res.start_step == 2, r
        np.testing.assert_allclose(res.losses, ref.losses[2:], rtol=1e-6)
        for (path, g), (_, w) in zip(tree_items(params),
                                     tree_items(ref_tr.params[r])):
            assert torch.equal(g, w), (r, path)


def test_session_checkpoints_and_resumes(tmp_path):
    """Session.train() passes ckpt_dir / ckpt_every to the loop: a second
    session on the same directory resumes where the first stopped."""
    ck = str(tmp_path / "ck")
    spec = JobSpec(arch="granite-3-2b", steps=2, batch=2, seq=8,
                   log_every=0, ckpt_dir=ck, ckpt_every=1)
    first = Session(spec, device="cpu").train()
    assert first.measured["start_step"] == 0 and latest_step(ck) == 2
    again = Session(spec.replace(steps=3), device="cpu").train()
    assert again.measured["start_step"] == 2
    assert again.measured["steps"] == 1 and latest_step(ck) == 3
