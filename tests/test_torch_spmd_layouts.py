"""The sharded train step's other layouts, on threaded gloo ranks over an
in-process ``HashStore`` (``tests/test_torch_spmd.py``'s harness; no
process is started), on the CPU in fp32:

* the sequence replicated over ``model`` (``seq_parallel=False``,
  Megatron's plain tensor parallelism) on reduced granite at (2, 2) with
  FSDP, on a 6-head llava at (1, 4) (replicated attention: its input
  gradient must not be summed over the model ranks) and on jamba at
  (2, 2) (the Mamba split and the MoE router, FSDP);
* a global batch of 1 at (2, 2), smaller than the data axes: the
  ``batch`` rule empty, the batch whole on every rank, on granite with
  FSDP (its gathers' backward takes the rank's slice) and on jamba
  without (the ZeRO-1 slice in ``land_grads``; the MoE aux averaged over
  ``model`` alone);
* microbatch accumulation on granite at (2, 2) with n = 2 (sequence
  parallel) and n = 4 (sequence replicated), with labels masked (-1) so
  that the microbatches' token counts differ.

Each layout's train step (loss to rtol 1e-4, the parameters after one
AdamW step to rtol 5e-3 / atol 3e-3), its landed gradients (assembled
with ``spmd.unshard_tree``, 2e-4 of each leaf's largest element; every
replica of a block equal) and the norm from the shards (rtol 1e-4)
against the port's single-device step: on the whole batch for the batch
of 1 and the microbatched layouts (with the same ``microbatch``), else
the mean of the data shards' gradients, as ``tests/test_torch_spmd.py``
holds them.  The meta dry run of rank 0's step issues the real run's
collectives op by op.  The port's single-device microbatch step is held
to JAX's ``build_train_step`` with ``RunConfig(microbatch=...)`` on
masked labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.models.common import materialize as jmaterialize
from repro.optim import adamw as jadamw
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.common import (materialize, smooth_attention,
                                       tree_items, tree_map, tree_unflatten)
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import init_state
from test_torch_spmd import (B, CASES, L, OPT, TIMEOUT, _batch, _cfg, _local,
                             _run, _threaded)

LAYOUTS = {
    # name: (case of tests/test_torch_spmd.py, global batch, context
    # options, run options)
    "granite_noseq": ("granite", B, {"fsdp": True, "seq_parallel": False},
                      {}),
    "llava_h6_noseq": ("llava_h6", B, {"seq_parallel": False}, {}),
    "jamba_noseq": ("jamba", B, {"fsdp": True, "seq_parallel": False}, {}),
    "granite_batch1": ("granite", 1, {"fsdp": True}, {}),
    "jamba_batch1": ("jamba", 1, {}, {}),
    "granite_mb2": ("granite", B, {"fsdp": True}, {"microbatch": 4}),
    "granite_mb4_noseq": ("granite", B, {"fsdp": True, "seq_parallel": False},
                          {"microbatch": 2}),
}


def _masked(labels, seed):
    """``labels`` with a different share of each row set to -1."""
    rng = np.random.default_rng(seed)
    out = labels.clone()
    for row in range(out.shape[0]):
        drop = rng.random(out.shape[1]) < row / out.shape[0]
        out[row, torch.from_numpy(drop)] = -1
    return out


def _context(name, mesh, rank, groups, cfg, **extra):
    _, batch, opts, _ = LAYOUTS[name]
    return mesh_lib.make_context(mesh, rank, groups, cfg,
                                 ShapeConfig(name, L, batch, "train"),
                                 **dict(opts, **extra))


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def laid_out(request):
    name = request.param
    case, gb, _, run_kw = LAYOUTS[name]
    cfg = _cfg(case)
    mesh = mesh_lib.Mesh(CASES[case][2], ("data", "model"))
    params = materialize(M.model_specs(cfg), 0, "cpu")
    if "wq" in params["slots"]["slot0"]["mixer"]:
        smooth_attention(params, cfg)
    batch = _batch(cfg, gb, L, 1)
    batch["labels"] = _batch(cfg, gb, L, 2)["tokens"]
    if run_kw:
        batch["labels"] = _masked(batch["labels"], 3)
        assert len({int((batch["labels"][i:i + 2] >= 0).sum())
                    for i in range(0, gb, 2)}) > 1

    # single device: the whole batch where the layout keeps it whole on
    # every rank or accumulates microbatches, else the mean of the data
    # shards' gradients (the MoE aux loss is each shard's estimate)
    dp = 1 if gb < mesh.shape["data"] or run_kw else mesh.shape["data"]
    per = [S.build_grad_fn(cfg, _run(**run_kw))(params, {
        k: v[d * gb // dp:(d + 1) * gb // dp] for k, v in batch.items()})[2]
        for d in range(dp)]
    g1 = tree_unflatten((path, sum(dict(tree_items(g))[path] for g in per)
                         / dp) for path, _ in tree_items(per[0]))
    n1 = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for _, g in tree_items(g1))))
    p1 = tree_map(torch.clone, params)
    p1, _, m1 = S.build_train_step(cfg, _run(**run_kw), OPT)(
        p1, init_state(OPT, p1), batch)

    def rank(r, store):
        log = []
        gr = mesh_lib.groups(mesh, r, store=store, device="cpu", log=log,
                             timeout=TIMEOUT)
        ctx = _context(name, mesh, r, gr, cfg)
        run = _run(shard=ctx, **run_kw)
        pl = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        st = S.zero_state(cfg, mesh, ctx.rules, OPT, "cpu")
        bl = _local(batch, mesh, r, ctx.rules)
        pl, st, m = S.build_train_step(cfg, run, OPT)(pl, st, bl)
        train_log = list(log)
        pl0 = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        _, _, gl = S.build_grad_fn(cfg, run)(pl0, bl)
        return {"params": pl, "loss": float(m["loss"]), "log": train_log,
                "batch": bl, "grads": gl, "rules": ctx.rules,
                "gnorm": float(spmd.global_norm(gl, ctx))}

    outs = _threaded(mesh, rank)
    return {"name": name, "cfg": cfg, "mesh": mesh, "run": run_kw,
            "single": (p1, float(m1["loss"])), "grads": (g1, n1),
            "outs": outs}


def test_layout_rules(laid_out):
    rules = laid_out["outs"][0]["rules"]
    if laid_out["name"].endswith("batch1"):
        assert rules["batch"] is None
        assert rules["kv_seq"] == ("data", "model")
    else:
        assert rules["batch"] == ("data",)


def test_layout_train_step_matches_single_device(laid_out):
    p1, loss1 = laid_out["single"]
    cfg, mesh, outs = laid_out["cfg"], laid_out["mesh"], laid_out["outs"]
    rules = outs[0]["rules"]
    for o in outs:
        assert o["loss"] == pytest.approx(loss1, rel=1e-4, abs=1e-5)
    specs = M.model_specs(cfg)
    full = spmd.unshard_tree([o["params"] for o in outs], specs, rules, mesh)
    for (path, a), (_, b) in zip(tree_items(p1), tree_items(full)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3,
                                   atol=3e-3, err_msg=str(path))
    for r, o in enumerate(outs):
        mine = spmd.shard_tree(full, specs, rules, mesh, r)
        for (path, a), (_, b) in zip(tree_items(mine),
                                     tree_items(o["params"])):
            assert torch.equal(a, b), (r, path)


def test_layout_grads_match_single_device(laid_out):
    g1, n1 = laid_out["grads"]
    cfg, mesh, outs = laid_out["cfg"], laid_out["mesh"], laid_out["outs"]
    specs = M.model_specs(cfg)
    zrules = mesh_lib.zero_rules(mesh, outs[0]["rules"])
    full = spmd.unshard_tree([o["grads"] for o in outs], specs, zrules, mesh)
    for (path, a), (_, b) in zip(tree_items(g1), tree_items(full)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                   atol=2e-4 * float(a.abs().max()),
                                   err_msg=str(path))
    for r, o in enumerate(outs):
        mine = spmd.shard_tree(full, specs, zrules, mesh, r)
        for (path, a), (_, b) in zip(tree_items(mine), tree_items(o["grads"])):
            assert torch.equal(a, b), (r, path)
        assert o["gnorm"] == pytest.approx(n1, rel=1e-4)


def test_layout_meta_dry_run_records_equal_the_real_run(laid_out):
    """Rank 0's step traced on meta under RecordingGroups issues the real
    run's collectives op by op: the all-to-all of the microbatches' rows,
    the counts' all-reduce, each pass's FSDP gathers, the model-axis sums
    of the split regions' replicated leaves alone."""
    name, cfg, mesh = laid_out["name"], laid_out["cfg"], laid_out["mesh"]
    o = laid_out["outs"][0]
    log = []
    ctx = _context(name, mesh, 0, mesh_lib.recording_groups(mesh, 0, log),
                   cfg)
    params = S.abstract_params(cfg, mesh, ctx.rules)
    state = S.abstract_opt_state(cfg, mesh, ctx.rules, OPT)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in o["batch"].items()}
    traced = D.trace(S.build_train_step(
        cfg, _run(shard=ctx, **laid_out["run"]), OPT), (params, state, batch),
        log)
    assert traced["records"] == o["log"]
    if laid_out["run"]:
        assert sum(r["op"] == "all-to-all" for r in o["log"]) == len(batch)


def test_microbatch_rows_that_do_not_split_raise():
    """n = 8 microbatches of one row cannot spread over 2 data ranks."""
    cfg = _cfg("granite")
    mesh = mesh_lib.Mesh((2, 2), ("data", "model"))
    ctx = mesh_lib.make_context(mesh, 0, mesh_lib.recording_groups(mesh, 0),
                                cfg)
    batch = {k: torch.empty((B // 2, L), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    grads_of = S.build_grad_fn(cfg, _run(shard=ctx, microbatch=1))
    with pytest.raises(ValueError, match="global batch 8 .* 8 microbatches"):
        grads_of(S.abstract_params(cfg, mesh, ctx.rules), batch)


def test_single_device_microbatch_step_matches_jax():
    """The microbatched layouts' oracle: the port's single-device step with
    ``microbatch`` 2 (n = 4) against JAX's ``build_train_step`` on reduced
    granite (JAX's parameters, smoothed attention, masked labels)."""
    jcfg = jget_config("granite-3-2b").reduced().replace(dtype="float32")
    cfg = _cfg("granite")
    jp = jmaterialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                "cpu")
    smooth_attention(tparams, cfg)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()),
                                tree_map(torch.clone, tparams))
    batch = _batch(cfg, B, L, 1)
    batch["labels"] = _masked(_batch(cfg, B, L, 2)["tokens"], 3)
    jopt = jadamw.OptConfig(lr=1e-3, warmup_steps=0)
    jrun = jblocks.RunConfig(attn_impl="dense", remat="none", microbatch=2)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp2, _, jm = jax.jit(jbuild_train_step(jcfg, jrun, jopt))(
        jp, jadamw.init_state(jopt, jp), jb)
    p2, _, m = S.build_train_step(cfg, _run(microbatch=2), OPT)(
        tparams, init_state(OPT, tparams), batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    got = dict(tree_items(p2))
    for path, a in tree_items(jax.tree_util.tree_map(np.asarray, jp2)):
        np.testing.assert_allclose(got[path].numpy(), a, rtol=5e-3,
                                   atol=3e-3, err_msg=str(path))
