"""The explicit rank program (``distributed/spmd.py``) on threaded gloo
ranks over an in-process ``HashStore`` (no process is started), on the
CPU in fp32.

* Expert parallelism against the JAX package on JAX's own test config
  (``tests/test_distributed.py:7-35``: reduced jamba, E 8, k 2, D 64,
  capacity 8.0): each shard's ``_local_expert_pass`` against JAX's at the
  same ``e_lo`` (2e-4), and ``moe_mlp_sharded`` on a (2, 4) mesh against
  JAX's ``moe_mlp`` (2e-5; ``aux`` to rtol 2e-2, a mean of per-shard
  estimates, as JAX's bound).
* The sharded train, prefill and decode steps on a (2, 2) mesh against
  the port's single-device steps on the same weights: reduced granite
  (FSDP), deepseek-v2 (MLA + expert parallel + the dense prelude, FSDP),
  musicgen (codebooks; ZeRO-1 by reduce-scatter), jamba (the Mamba split,
  MoE, FSDP), qwen2 with GSPMD's baseline gradient all-reduce, and a
  llava variant with 6 heads on a (1, 4) mesh (replicated attention, as
  the rules give where the heads do not divide; the image prefix).  The
  train step's loss to rtol 1e-4 and the parameters after one AdamW
  step to rtol 5e-3 / atol 3e-3
  (``tests/test_distributed.py:86-92``); prefill's last logits, the
  caches and a decode step on sequence-sharded caches to 2e-4.  The
  backward pass on its own: each rank's gradients on the ZeRO-1 layout,
  assembled, against the single-device gradients (2e-4 of each leaf's
  largest element) and the norm from the shards (rtol 1e-4).  The MoE
  configs run at capacity 8.0: a shard's capacity counts its own tokens,
  so at 1.25 the shards would drop other assignments than one device.
  Attention weights are smoothed (ROADMAP convention).  The port's
  single-device step is held to JAX's ``build_train_step`` on granite.
* The meta dry run of rank 0's train step against the real run: the
  same collectives op by op (bytes and group sizes), and its argument
  bytes equal to rank 0's real tensors'.
"""
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.common import materialize as jmaterialize
from repro.optim import adamw as jadamw
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import (ParamSpec, materialize,
                                       smooth_attention, tree_items, tree_map,
                                       tree_unflatten)
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import OptConfig, init_state

TIMEOUT = timedelta(seconds=120)
CF = 8.0
OPT = OptConfig(lr=1e-3, warmup_steps=0)
B, L = 8, 32  # train batch
BP, P, SMAX = 4, 16, 32  # prefill batch, prompt, decode cache length


def _threaded(mesh, fn):
    """``fn(rank, store)`` on one thread per rank; re-raises a rank's
    error."""
    store = dist.HashStore()
    out, errs = [None] * mesh.size, []

    def body(r):
        try:
            out[r] = fn(r, store)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


# ---------------------------------------------------------------------------
# Expert parallelism against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_case():
    kw = dict(num_experts=8, top_k=2, moe_d_ff=64, d_model=64)
    jcfg = jget_config("jamba-1.5-large-398b").reduced().replace(**kw)
    tcfg = get_config("jamba-1.5-large-398b").reduced().replace(**kw)
    p = jmaterialize(jmoe.moe_specs(jcfg, 1), jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64), jnp.float32)
    base, aux = jmoe.moe_mlp(p, x, jcfg, capacity_factor=CF)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return jcfg, tcfg, p, x, tp, np.asarray(base), float(aux)


@pytest.mark.parametrize("e_lo", (0, 2, 4, 6))
def test_local_expert_pass_matches_jax(moe_case, e_lo):
    jcfg, tcfg, p, x, tp, _, _ = moe_case
    xf = x.reshape(-1, 64)
    sl = slice(e_lo, e_lo + 2)
    want, waux = jmoe._local_expert_pass(
        xf, p["router"], p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl],
        jcfg, CF, e_lo, 2)
    got, gaux = tmoe._local_expert_pass(
        torch.from_numpy(np.array(xf)), tp["router"], tp["w_gate"][sl],
        tp["w_up"][sl], tp["w_down"][sl], tcfg, CF, e_lo, 2)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())
    assert float(gaux) == pytest.approx(float(waux), rel=2e-4)


def test_moe_mlp_sharded_matches_jax_moe_mlp(moe_case):
    jcfg, tcfg, p, x, tp, base, aux = moe_case
    mesh = mesh_lib.Mesh((2, 4), ("data", "model"))
    xt = torch.from_numpy(np.array(x))

    def rank(r, store):
        gr = mesh_lib.groups(mesh, r, store=store, device="cpu",
                             timeout=TIMEOUT)
        ctx = mesh_lib.make_context(mesh, r, gr, tcfg)
        di, mi = mesh.axis_index("data", r), mesh.axis_index("model", r)
        pl = {k: v if k == "router" else v[2 * mi: 2 * mi + 2]
              for k, v in tp.items()}
        xl = xt[2 * di: 2 * di + 2, 4 * mi: 4 * mi + 4]
        return tmoe.moe_mlp_sharded(pl, xl, tcfg, mesh=ctx,
                                    capacity_factor=CF)

    outs = _threaded(mesh, rank)
    got = torch.zeros(4, 16, 64)
    for r, (o, a) in enumerate(outs):
        di, mi = mesh.axis_index("data", r), mesh.axis_index("model", r)
        got[2 * di: 2 * di + 2, 4 * mi: 4 * mi + 4] = o
        assert float(a) == float(outs[0][1])
    np.testing.assert_allclose(got.numpy(), base, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(outs[0][1]), aux, rtol=2e-2)


# ---------------------------------------------------------------------------
# The sharded steps against the single-device ones
# ---------------------------------------------------------------------------

CASES = {
    # name: (arch, config overrides, mesh dims, context options)
    "granite": ("granite-3-2b", {}, (2, 2), {"fsdp": True}),
    "deepseek": ("deepseek-v2-236b", {"num_layers": 2}, (2, 2),
                 {"fsdp": True}),
    "musicgen": ("musicgen-large", {}, (2, 2), {}),
    "jamba": ("jamba-1.5-large-398b", {}, (2, 2), {"fsdp": True}),
    "llava_h6": ("llava-next-34b", {"num_heads": 6, "num_kv_heads": 2,
                                    "head_dim": 32}, (1, 4), {}),
    # GSPMD's baseline: the data-axis sum by all-reduce, then the slice
    "qwen2_allreduce": ("qwen2-72b", {}, (2, 2),
                        {"grad_reduce_scatter": False}),
}


def _cfg(name):
    arch, kw, _, _ = CASES[name]
    return get_config(arch).reduced().replace(dtype="float32", **kw)


def _run(**kw):
    return RunConfig(attn_impl="chunked", remat="block", kv_block=16,
                     q_block=16, capacity_factor=CF, **kw)


def _batch(cfg, b, n, seed):
    rng = np.random.default_rng(seed)
    shape = (b, n, cfg.num_codebooks) if cfg.num_codebooks else (b, n)
    out = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, shape),
                                  dtype=torch.int32)}
    if cfg.num_image_tokens:
        out["image_embeds"] = torch.tensor(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)), dtype=torch.float32)
    return out


def _placed_caches(cfg, caches, s_max):
    """Prefill caches (cycles, B, S, ...) placed at the front of zeroed
    caches ``s_max`` long."""
    full = tree_map(lambda sp: torch.zeros(sp.shape),
                    M.cache_specs(cfg, BP, s_max, "float32"))
    for path, t in tree_items(caches):
        node = full
        for k in path[:-1]:
            node = node[k]
        tgt = node[path[-1]]
        if tgt.shape == t.shape:
            tgt.copy_(t)
        else:
            tgt[:, :, :t.shape[2]] = t
    return full


def _local(tree, mesh, r, rules, batch_dim=0):
    """This rank's rows of a batch (the batch rule's axes)."""
    axes = rules["batch"]
    n = mesh.axis_size(axes)
    i = mesh.axis_index(axes, r) if axes else 0
    return {k: v.narrow(batch_dim, i * (v.shape[batch_dim] // n),
                        v.shape[batch_dim] // n) for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    name = request.param
    cfg = _cfg(name)
    _, _, dims, opts = CASES[name]
    mesh = mesh_lib.Mesh(dims, ("data", "model"))
    params = materialize(M.model_specs(cfg), 0, "cpu")
    if "wq" in params["slots"]["slot0"]["mixer"]:
        smooth_attention(params, cfg)
    batch = _batch(cfg, B, L, 1)
    batch["labels"] = _batch(cfg, B, L, 2)["tokens"]
    prompt = _batch(cfg, BP, P, 3)

    # single device; the gradients as the mean of each data shard's (the
    # MoE aux loss is each shard's own estimate, averaged, as JAX's)
    dp = mesh.shape["data"]
    per = [S.build_grad_fn(cfg, _run())(params, {
        k: v[d * B // dp:(d + 1) * B // dp] for k, v in batch.items()})[2]
        for d in range(dp)]
    g1 = tree_unflatten((path, sum(dict(tree_items(g))[path] for g in per) / dp)
                        for path, _ in tree_items(per[0]))
    n1 = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for _, g in tree_items(g1))))
    p1 = tree_map(torch.clone, params)
    p1, _, m1 = S.build_train_step(cfg, _run(), OPT)(
        p1, init_state(OPT, p1), batch)
    lg1, c1 = S.build_prefill_step(cfg, _run())(params, prompt)
    placed = _placed_caches(cfg, c1, SMAX)
    s_full = P + (cfg.num_image_tokens or 0)
    pos = torch.full((BP,), s_full, dtype=torch.int32)
    tok = prompt["tokens"][:, :1]
    lgd1, _ = S.build_decode_step(cfg, _run())(
        params, tok, pos, tree_map(torch.clone, placed))

    def rank(r, store):
        log = []
        gr = mesh_lib.groups(mesh, r, store=store, device="cpu", log=log,
                             timeout=TIMEOUT)
        ctx = mesh_lib.make_context(mesh, r, gr, cfg, **opts)
        run = _run(shard=ctx)
        pl = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        st = S.zero_state(cfg, mesh, ctx.rules, OPT, "cpu")
        bl = _local(batch, mesh, r, ctx.rules)
        arg_bytes = sum(t.numel() * t.element_size() for t in
                        [t for _, t in tree_items(pl)]
                        + [t for _, t in tree_items({"m": st["m"],
                                                     "v": st["v"]})]
                        + list(bl.values()))
        pl, st, m = S.build_train_step(cfg, run, OPT)(pl, st, bl)
        train_log = list(log)
        pl0 = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        lg, cc = S.build_prefill_step(cfg, run)(
            pl0, _local(prompt, mesh, r, ctx.rules))
        cl = spmd.shard_tree(placed, M.cache_specs(cfg, BP, SMAX, "float32"),
                             ctx.rules, mesh, r)
        lb = _local({"t": tok, "p": pos}, mesh, r, ctx.rules)
        lgd, _ = S.build_decode_step(cfg, run)(pl0, lb["t"], lb["p"], cl)
        _, _, gl = S.build_grad_fn(cfg, run)(pl0, bl)
        return {"params": pl, "loss": float(m["loss"]), "log": train_log,
                "arg_bytes": arg_bytes, "prefill": lg, "caches": cc,
                "decode": lgd, "batch": bl, "opt": st, "grads": gl,
                "gnorm": float(spmd.global_norm(gl, ctx))}

    outs = _threaded(mesh, rank)
    return {"name": name, "cfg": cfg, "mesh": mesh, "opts": opts,
            "single": (p1, float(m1["loss"]), lg1, c1, lgd1),
            "grads": (g1, n1), "outs": outs}


def _rules(st):
    return mesh_lib.make_context(st["mesh"], 0, {}, st["cfg"],
                             **st["opts"]).rules


def test_sharded_train_step_matches_single_device(stepped):
    p1, loss1, *_ = stepped["single"]
    cfg, mesh, outs = stepped["cfg"], stepped["mesh"], stepped["outs"]
    for o in outs:
        assert o["loss"] == pytest.approx(loss1, rel=1e-4, abs=1e-5)
    full = spmd.unshard_tree([o["params"] for o in outs],
                             M.model_specs(cfg), _rules(stepped), mesh)
    for (path, a), (_, b) in zip(tree_items(p1), tree_items(full)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3,
                                   atol=3e-3, err_msg=str(path))
    # every replica of a leaf holds the same values
    for r, o in enumerate(outs):
        mine = spmd.shard_tree(full, M.model_specs(cfg), _rules(stepped),
                               mesh, r)
        for (path, a), (_, b) in zip(tree_items(mine),
                                     tree_items(o["params"])):
            assert torch.equal(a, b), (r, path)


def test_sharded_grads_match_single_device(stepped):
    """The backward pass on the mesh: every rank's gradients, landed on
    the ZeRO-1 layout (``embed`` on the data axes) and assembled, equal the
    single-device gradients of the whole batch, each leaf to 2e-4 of its
    largest element; every replica of a block holds the same values; and
    the norm each rank computes from its shards is the whole gradient's.
    After one AdamW step the parameters cannot show a wrong gradient: the
    first step moves each element by about lr whatever the gradient's
    size."""
    g1, n1 = stepped["grads"]
    cfg, mesh, outs = stepped["cfg"], stepped["mesh"], stepped["outs"]
    specs = M.model_specs(cfg)
    zrules = mesh_lib.zero_rules(mesh, _rules(stepped))
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


def _close(got, want, tol=2e-4):
    scale = max(float(want.abs().max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                               atol=tol * scale)


def test_sharded_prefill_and_decode_match_single_device(stepped):
    _, _, lg1, c1, lgd1 = stepped["single"]
    cfg, mesh, outs = stepped["cfg"], stepped["mesh"], stepped["outs"]
    rules = _rules(stepped)
    lax = ("batch", None, None, "vocab") if cfg.num_codebooks else \
        ("batch", None, "vocab")
    for key, want in (("prefill", lg1), ("decode", lgd1)):
        got = spmd.unshard_tree([{"l": o[key]} for o in outs],
                                {"l": ParamSpec(tuple(want.shape), lax)},
                                rules, mesh)["l"]
        _close(got, want)
    s_full = c1["slots"]["slot0"][sorted(c1["slots"]["slot0"])[0]].shape[2]
    specs = M.cache_specs(cfg, BP, s_full, "float32")
    if any(s.mixer == "mamba" for s in cfg.pattern):
        s_full = None  # Mamba caches have no sequence dim
    full = spmd.unshard_tree([o["caches"] for o in outs], specs, rules, mesh)
    for (path, a), (_, b) in zip(tree_items(c1), tree_items(full)):
        _close(b, a)


def test_meta_dry_run_records_equal_the_real_run(stepped):
    """Rank 0's train step traced on meta under RecordingGroups issues the
    real run's collectives, op by op, and reads as many argument bytes as
    rank 0's real tensors hold."""
    cfg, mesh, o = stepped["cfg"], stepped["mesh"], stepped["outs"][0]
    log = []
    ctx = spmd.ShardContext(mesh=mesh, rank=0,
                            groups=mesh_lib.recording_groups(mesh, 0, log),
                            rules=_rules(stepped), specs=M.model_specs(cfg),
                            **stepped["opts"])
    params = S.abstract_params(cfg, mesh, ctx.rules)
    state = S.abstract_opt_state(cfg, mesh, ctx.rules, OPT)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in o["batch"].items()}
    traced = D.trace(S.build_train_step(cfg, _run(shard=ctx), OPT),
                     (params, state, batch), log)
    assert traced["records"] == o["log"]
    assert traced["argument_bytes"] == o["arg_bytes"]
    assert traced["flops"] > 0 and traced["temp_bytes"] > 0


def test_decode_with_the_sequence_over_data_and_model():
    """long_500k's layout: a batch smaller than the data axes stays whole
    on every rank and the caches' sequence splits over data x model."""
    cfg = _cfg("granite")
    mesh = mesh_lib.Mesh((2, 2), ("data", "model"))
    shape = ShapeConfig("long", SMAX, 1, "decode")
    params = smooth_attention(materialize(M.model_specs(cfg), 0, "cpu"), cfg)
    prompt = _batch(cfg, 1, P, 3)
    _, c1 = S.build_prefill_step(cfg, _run())(params, prompt)
    placed = tree_map(lambda t: t[:, :1].clone(),
                      _placed_caches(cfg, tree_map(
                          lambda t: t.expand((t.shape[0], BP) + t.shape[2:]),
                          c1), SMAX))
    pos = torch.full((1,), P, dtype=torch.int32)
    tok = prompt["tokens"][:, :1]
    want, _ = S.build_decode_step(cfg, _run())(params, tok, pos,
                                               tree_map(torch.clone, placed))

    def rank(r, store):
        gr = mesh_lib.groups(mesh, r, store=store, device="cpu",
                             timeout=TIMEOUT)
        ctx = mesh_lib.make_context(mesh, r, gr, cfg, shape)
        assert ctx.rules["kv_seq"] == ("data", "model")
        pl = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        cl = spmd.shard_tree(placed, M.cache_specs(cfg, 1, SMAX, "float32"),
                             ctx.rules, mesh, r)
        return S.build_decode_step(cfg, _run(shard=ctx))(pl, tok, pos, cl)

    outs = _threaded(mesh, rank)
    rules = mesh_lib.make_context(mesh, 0, {}, cfg, shape).rules
    got = spmd.unshard_tree([{"l": o[0]} for o in outs],
                            {"l": ParamSpec(tuple(want.shape),
                                            ("batch", None, "vocab"))},
                            rules, mesh)["l"]
    _close(got, want)


def test_single_device_step_matches_jax():
    """The oracle the sharded steps are held to: the port's single-device
    train step against JAX's ``build_train_step`` on reduced granite
    (JAX's parameters, smoothed attention)."""
    jcfg = jget_config("granite-3-2b").reduced().replace(dtype="float32")
    cfg = _cfg("granite")
    jp = jmaterialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                                "cpu")
    smooth_attention(tparams, cfg)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.numpy()),
        tree_map(torch.clone, tparams))
    batch = _batch(cfg, B, L, 1)
    batch["labels"] = _batch(cfg, B, L, 2)["tokens"]
    jopt = jadamw.OptConfig(lr=1e-3, warmup_steps=0)
    jrun = jblocks.RunConfig(attn_impl="dense", remat="none")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp2, _, jm = jax.jit(jbuild_train_step(jcfg, jrun, jopt))(
        jp, jadamw.init_state(jopt, jp), jb)
    p2, _, m = S.build_train_step(cfg, _run(), OPT)(
        tparams, init_state(OPT, tparams), batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    got = dict(tree_items(p2))
    for path, a in tree_items(jax.tree_util.tree_map(np.asarray, jp2)):
        np.testing.assert_allclose(got[path].numpy(), a, rtol=5e-3,
                                   atol=3e-3, err_msg=str(path))


@pytest.mark.parametrize("kv_quant", (False, True))
def test_decode_on_wrapped_rings_and_int8_caches(kv_quant):
    """gemma2's sliding-window slots decode on a ring shorter than the
    sequence (window 16 < s_max 32, 20 tokens written, so the ring has
    wrapped): each model rank holds half the ring's slots, only the owner
    of the step's slot writes it.  With ``kv_quant`` the caches are int8
    with fp32 scales (the dry run's --opt decode)."""
    cfg = get_config("gemma2-27b").reduced().replace(dtype="float32",
                                                     sliding_window=16)
    mesh = mesh_lib.Mesh((2, 2), ("data", "model"))
    params = smooth_attention(materialize(M.model_specs(cfg), 0, "cpu"), cfg)
    specs = M.cache_specs(cfg, BP, SMAX, "float32", kv_quant=kv_quant)
    caches = tree_map(lambda sp: torch.zeros(
        sp.shape, dtype=getattr(torch, sp.dtype)), specs)
    toks = _batch(cfg, BP, 21, 5)["tokens"]
    step = S.build_decode_step(cfg, _run())
    for t in range(20):  # fill every cache token by token
        _, caches = step(params, toks[:, t:t + 1], torch.full(
            (BP,), t, dtype=torch.int32), caches)
    assert caches["slots"]["slot0"]["k"].shape[2] == 16
    pos = torch.full((BP,), 20, dtype=torch.int32)
    want, _ = step(params, toks[:, 20:21], pos, tree_map(torch.clone, caches))

    def rank(r, store):
        gr = mesh_lib.groups(mesh, r, store=store, device="cpu",
                             timeout=TIMEOUT)
        ctx = mesh_lib.make_context(mesh, r, gr, cfg)
        pl = spmd.shard_tree(params, ctx.specs, ctx.rules, mesh, r)
        cl = spmd.shard_tree(caches, specs, ctx.rules, mesh, r)
        lb = _local({"t": toks[:, 20:21], "p": pos}, mesh, r, ctx.rules)
        return S.build_decode_step(cfg, _run(shard=ctx))(pl, lb["t"],
                                                         lb["p"], cl)

    outs = _threaded(mesh, rank)
    rules = mesh_lib.make_context(mesh, 0, {}, cfg).rules
    got = spmd.unshard_tree([{"l": o[0]} for o in outs],
                            {"l": ParamSpec(tuple(want.shape),
                                            ("batch", None, "vocab"))},
                            rules, mesh)["l"]
    _close(got, want)
