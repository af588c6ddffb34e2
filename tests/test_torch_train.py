"""The port's training path against the JAX package's, on the same
parameters (JAX's ``materialize`` output carried over with
``params_from_numpy``) and the same numpy-made inputs.

Config: granite-3-2b reduced with vocab 512, the single-device oracle of
tests/test_distributed.py:52-62 (params from PRNGKey(0), tokens (8, 32)
from default_rng(0), lr 1e-3, no warmup, dense attention, no remat).  The
fp32 comparisons set ``dtype="float32"``: XLA and PyTorch round bf16
differently inside fused ops (tests/test_torch_models.py's docstring), so
2e-4 (tests/test_kernels.py's fp32 tolerance) holds at fp32 compute, and
the bf16 path (``bf16_grads``) is held at the bf16 tolerance 3e-2.  A
tolerance is taken relative to each tensor's scale (max |want|), as in
tests/test_torch_models.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import hardware as jhw
from repro.core import pipeline as jpipe
from repro.core import ps as jps
from repro.data import pipeline as jdata
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models.blocks import RunConfig as JRun
from repro.optim import adamw as jopt
from repro.train import loop as jloop
from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.core import hardware as thw
from repro_torch.core import ps as tps
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.launch.steps import build_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM
from repro_torch.models.blocks import RunConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as topt
from repro_torch.train import loop as tloop

TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _cfgs(**kw):
    kw = {"vocab_size": 512, "dtype": "float32", **kw}
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32", what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype]
    err = np.abs(got - want).max() if got.size else 0.0
    bound = tol + tol * np.abs(want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound} ({dtype})"


def _leaves(tree):
    """{path string: leaf} of a JAX or a port parameter tree (both are
    nested dicts)."""
    return {tcommon.path_str(p): v for p, v in tcommon.tree_items(tree)}


def _close_trees(got, want, dtype="float32", what=""):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for name in sorted(w):
        _close(g[name], w[name], dtype, f"{what} {name}")


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg, "cpu")


def _copy(tp):
    return tcommon.tree_map(lambda a: a.clone(), tp)


@pytest.fixture(scope="module")
def oracle():
    """The oracle config, params and batch: tokens (8, 32), labels =
    tokens, as tests/test_distributed.py:52-62."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    return jcfg, tcfg, jp, tp, {"tokens": toks, "labels": toks}


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_entropy_matches_jax(cap):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 50)) * 20).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    mask = (labels >= 0).astype(np.float32)
    safe = np.maximum(labels, 0)

    def jloss(lg):
        return jcommon.cross_entropy(lg, jnp.asarray(safe), jnp.asarray(mask),
                                     logit_cap=cap)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    tval = tcommon.cross_entropy(lt, torch.from_numpy(safe),
                                 torch.from_numpy(mask), logit_cap=cap)
    tval.backward()
    _close(tval, jval, what="ce")
    _close(lt.grad, jgrad, what="d ce / d logits")


@pytest.mark.parametrize("Sq,kv_block,q_block,window,cap", [
    (37, 8, 16, 0, 0.0),      # ragged q and k blocks: padding + k_pos 2**30
    (37, 8, 16, 10, 20.0),    # sliding window + tanh cap
    (19, 5, 7, 6, 0.0),
    (24, 8, 8, 0, 30.0),      # blocks that divide
])
def test_chunked_attention_matches_jax(Sq, kv_block, q_block, window, cap):
    rng = np.random.default_rng(4)
    B, H, KV, D = 2, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sq, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sq, KV, D)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    kw = dict(scale=D ** -0.5, window=window, cap=cap, kv_block=kv_block,
              q_block=q_block)

    def jf(q, k, v):
        out = jattn.chunked_attention(q, k, v, jnp.asarray(pos),
                                      jnp.asarray(pos), **kw)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    tout = tattn.chunked_attention(tq, tk, tv, tpos, tpos, **kw)
    torch.sum(tout * torch.from_numpy(w)).backward()
    _close(tout, jout, what="chunked out")
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        _close(t.grad, j, what=f"d/d{name}")
    dense = tattn.dense_attention(tq, tk, tv, tpos, tpos, scale=kw["scale"],
                                  window=window, cap=cap)
    _close(tout, dense, what="chunked vs dense")


@pytest.mark.parametrize("Sk,want", [(2048, "dense"), (2049, "chunked")])
def test_auto_picks_the_impl_jax_picks(monkeypatch, Sk, want):
    calls = []
    for mod, tag in ((jattn, "jax"), (tattn, "torch")):
        for name in ("dense_attention", "chunked_attention"):
            monkeypatch.setattr(
                mod, name,
                lambda *a, _n=name, _t=tag, **k: calls.append((_t, _n)))
    q = np.zeros((1, 1, 2, 8), np.float32)
    k = np.zeros((1, Sk, 1, 8), np.float32)
    pos = np.zeros((1, 1), np.int32)
    kpos = np.zeros((1, Sk), np.int32)
    jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                    jnp.asarray(pos), jnp.asarray(kpos), scale=1.0,
                    impl="auto")
    tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(k), torch.from_numpy(pos),
                    torch.from_numpy(kpos), scale=1.0, impl="auto")
    assert calls == [("jax", f"{want}_attention"),
                     ("torch", f"{want}_attention")]


def _smooth(jp, cfg):
    """The attention projections rescaled to std 1/sqrt(fan-in of the whole
    product), as chip_smoke.py's reference check does.  JAX's init takes
    fan-in = heads for the (D,H,hd) projections, which makes the scores'
    std ~64 and the softmax nearly one-hot; through two layers the
    backward pass then amplifies 1-ulp forward differences to ~3e-3 of
    the gradients' scale, while with smooth attention the two packages
    agree to ~2e-6."""
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    mix = dict(jp["slots"]["slot0"]["mixer"])
    for name, f in (("wq", (H / D) ** 0.5), ("wk", (KV / D) ** 0.5),
                    ("wv", (KV / D) ** 0.5), ("wo", H ** -0.5)):
        mix[name] = mix[name] * f
    return {**jp, "slots": {"slot0": {**jp["slots"]["slot0"], "mixer": mix}}}


@pytest.mark.parametrize("layers,image", [(1, False), (1, True), (2, False)])
def test_loss_fn_and_grads_match_jax(layers, image):
    """loss_fn and the gradient of every leaf against
    jax.value_and_grad(M.loss_fn), -1 labels masked; with an image prefix
    the labels are padded in front.  One layer at JAX's init; two layers
    (the stacked cycles) with smooth attention (see _smooth)."""
    jcfg, tcfg = _cfgs(num_layers=layers)
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(1))
    if layers > 1:
        jp = _smooth(jp, jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int32)
    labels[1, 5:9] = -1
    batch = {"tokens": toks, "labels": labels}
    if image:
        batch["image_embeds"] = (rng.standard_normal(
            (2, 4, jcfg.d_model)) * 0.02).astype(np.float32)
    jrun = JRun(attn_impl="dense", remat="none")
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, jrun), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = tcommon.tree_map(lambda a: a.requires_grad_(), _copy(tp))
    tl, tm = TM.loss_fn(leaves, tb, tcfg, RunConfig(attn_impl="dense",
                                                    remat="none"))
    tl.backward()
    _close(tl, jl, what="loss")
    _close(tm["ce"], jm["ce"], what="ce")
    _close_trees(tcommon.tree_map(lambda a: a.grad, leaves), jg,
                 what="grad")


def test_remat_block_gives_the_grads_of_none():
    _, tcfg = _cfgs(num_layers=3)
    tp = tcommon.materialize(TM.model_specs(tcfg), 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (2, 24)).astype(np.int32))
    grads = {}
    for remat in ("none", "block"):
        leaves = tcommon.tree_map(lambda a: a.clone().requires_grad_(), tp)
        loss, _ = TM.loss_fn(leaves, {"tokens": toks, "labels": toks}, tcfg,
                             RunConfig(attn_impl="auto", remat=remat))
        loss.backward()
        grads[remat] = (loss.detach(),
                        tcommon.tree_map(lambda a: a.grad, leaves))
    torch.testing.assert_close(grads["block"][0], grads["none"][0],
                               rtol=0, atol=0)
    for (path, g), (_, w) in zip(tcommon.tree_items(grads["block"][1]),
                                 tcommon.tree_items(grads["none"][1])):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7,
                                   msg=tcommon.path_str(path))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", [
    dict(), dict(warmup_steps=3, total_steps=10), dict(warmup_steps=0),
    dict(warmup_steps=1, total_steps=4, lr=1e-3)])
def test_schedule_matches_jax(opt):
    for step in range(0, 14):
        want = float(jopt.schedule(jopt.OptConfig(**opt), jnp.int32(step)))
        got = topt.schedule(topt.OptConfig(**opt), step)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (step, got,
                                                                 want)


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    return draw(1.0), [draw(0.5), draw(2.0)]


@pytest.mark.parametrize("clip", [1.0, 100.0])  # scaled, and left alone
def test_clip_by_global_norm_matches_jax(clip):
    _, (g, _) = _opt_trees(7)
    jg, jn = jopt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), clip)
    tg, tn = topt.clip_by_global_norm(
        tcommon.tree_map(torch.from_numpy, g), clip)
    _close(tn, jn, what="global norm")
    _close_trees(tg, jg, what="clipped")


@pytest.mark.parametrize("kind", ["adamw", "momentum"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_apply_updates_matches_jax(kind, grad_clip):
    """Two updates from the same params and grads; the "ef" slot passes
    through untouched."""
    p, grads = _opt_trees(8)
    cfg = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=5,
               grad_clip=grad_clip)
    jo, to = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jopt.init_state(jo, jp, error_feedback=True)
    tp = tcommon.tree_map(torch.from_numpy, p)
    ts = topt.init_state(to, tp, error_feedback=True)
    ef = ts["ef"]
    for g in grads:
        jp, js, jn = jopt.apply_updates(jo, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js)
        tp, ts, tn = topt.apply_updates(to, tp, tcommon.tree_map(
            torch.from_numpy, g), ts)
        _close(tn, jn, what="grad_norm")
        _close_trees(tp, jp, what="params")
        _close_trees(ts["m"], js["m"], what="m")
        if kind == "adamw":
            _close_trees(ts["v"], js["v"], what="v")
    assert ts["step"] == int(js["step"]) == 2
    assert ts["ef"] is ef
    assert all(float(t.abs().max()) == 0.0
               for _, t in tcommon.tree_items(ts["ef"]))
    assert set(ts) == set(js)


# ---------------------------------------------------------------------------
# The train step (the oracle of tests/test_distributed.py:52-62)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "microbatch2", "bf16_grads"])
def test_train_step_matches_jax_oracle(oracle, variant):
    jcfg, tcfg, jp, tp, batch = oracle
    dtype = "float32"
    run_kw = dict(attn_impl="dense", remat="none")
    if variant == "microbatch2":
        run_kw["microbatch"] = 2
    if variant == "bf16_grads":
        run_kw["bf16_grads"] = True
        dtype = "bfloat16"
        jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    jo, to = (m.OptConfig(lr=1e-3, warmup_steps=0) for m in (jopt, topt))
    jstep = jax.jit(jax_build_train_step(jcfg, JRun(**run_kw), jo))
    p1, _, m1 = jstep(jp, jopt.init_state(jo, jp),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _copy(tp)
    p2, s2, m2 = build_train_step(tcfg, RunConfig(**run_kw), to)(
        tparams, topt.init_state(to, tparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(m2["loss"], m1["loss"], dtype, "loss")
    _close(m2["grad_norm"], m1["grad_norm"], dtype, "grad_norm")
    _close_trees(p2, p1, dtype, "updated params")
    assert s2["step"] == 1


# ---------------------------------------------------------------------------
# Data, loop
# ---------------------------------------------------------------------------


def _stream(loader, n):
    out = []
    for _ in range(n):
        b, _ = next(loader)
        out.append({k: np.asarray(v) for k, v in b.items()})
    loader.close()
    return out


@pytest.mark.parametrize("arch,skip", [("granite-3-2b", 0),
                                       ("granite-3-2b", 3),
                                       ("llava-next-34b", 2)])
def test_token_stream_matches_jax(arch, skip):
    """Same batches as JAX's loader, bit for bit (image prefix included),
    with and without the skip_batches fast-forward."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    want = _stream(jdata.PrefetchLoader(
        jcfg, 4, 16, corpus=jdata.SyntheticCorpus(
            jcfg.vocab_size, shard_tokens=1000, seed=1), seed=1,
        skip_batches=skip), 4)
    got = _stream(tdata.PrefetchLoader(
        tcfg, 4, 16, device="cpu", corpus=tdata.SyntheticCorpus(
            tcfg.vocab_size, shard_tokens=1000, seed=1), seed=1,
        skip_batches=skip), 4)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    # a shard per rank: the same batch, split along the batch dim
    sharded = _stream(tdata.PrefetchLoader(
        tcfg, 4, 16, device=["cpu", "cpu"], corpus=tdata.SyntheticCorpus(
            tcfg.vocab_size, shard_tokens=1000, seed=1), seed=1,
        skip_batches=skip), 1)[0]
    for k in want[0]:
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(s) for s in sharded[k]]), want[0][k])


def test_train_loss_curve_matches_jax():
    """train() for 5 steps with the session's run config (auto attention,
    block remat) and warmup: the port's loss curve against JAX's train()
    from the same params and loader seed."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    kw = dict(batch=4, seq=32, steps=5, seed=3, log_every=0)
    jo, to = (m.OptConfig(lr=1e-3, warmup_steps=1, total_steps=5)
              for m in (jopt, topt))
    want = jloop.train(jcfg, JRun(attn_impl="auto", remat="block"), jo,
                       params=jax.tree_util.tree_map(jnp.array, jp), **kw)
    got = tloop.train(tcfg, RunConfig(attn_impl="auto", remat="block"), to,
                      device="cpu", params=tp, **kw)
    assert len(got.losses) == 5
    _close(np.asarray(got.losses), np.asarray(want.losses), what="losses")
    assert set(got.summary()) == set(want.summary())
    assert got.losses[-1] < got.losses[0]


# ---------------------------------------------------------------------------
# Lemma 3.2 and the cluster tables
# ---------------------------------------------------------------------------


def test_ps_and_hardware_match_jax():
    for s_p in (1e6, 3.3e9):
        for dp in (1, 2, 3, 8):
            for bw in (1.25e9, 50e9):
                for t_c in (0.01, 2.0):
                    assert tps.n_parameter_servers(s_p, dp, bw, t_c) == \
                        jps.n_parameter_servers(s_p, dp, bw, t_c)
                    assert tps.masked(s_p, dp, 2, bw, t_c) == \
                        jps.masked(s_p, dp, 2, bw, t_c)
                assert tps.io_time(s_p, dp, 3, bw) == jps.io_time(s_p, dp, 3, bw)
                assert tps.flat_wire_bytes(s_p, dp) == \
                    jps.flat_wire_bytes(s_p, dp)
                for sched in tps.SCHEDULES:
                    assert tps.predicted_comm_time(sched, s_p, dp, bw, n_ps=2) \
                        == jps.predicted_comm_time(sched, s_p, dp, bw, n_ps=2)
            assert tps.hier_wire_bytes(s_p, (4, dp)) == \
                jps.hier_wire_bytes(s_p, (4, dp))
    assert tps.SCHEDULES == jps.SCHEDULES
    # the port's clusters are JAX's plus the H100 ones
    assert set(thw.CLUSTERS) - set(jhw.CLUSTERS) == {"h100-8", "h100-2x8"}
    for name, jc in jhw.CLUSTERS.items():
        tc = thw.get_cluster(name)
        for attr in ("n_chips", "tier_sizes", "tier_bws", "min_bw",
                     "bottleneck_tier"):
            assert getattr(tc, attr) == getattr(jc, attr), (name, attr)
        assert tc.chip.name == jc.chip.name
        for tp_ in (1, 2, 4, 3):
            if jc.n_chips % tp_:
                continue
            dp = jc.n_chips // tp_
            jt = jc.dp_view(dp, tp_)
            tt = tc.dp_view(dp, tp_)
            assert [(t.name, t.size, t.bw, t.latency) for t in tt] == \
                [(t.name, t.size, t.bw, t.latency) for t in jt]
        t_total, t_tiers = tps.hier_comm_time(3e9, tc.tiers)
        j_total, j_tiers = jps.hier_comm_time(3e9, jc.tiers)
        assert t_total == j_total and t_tiers == j_tiers
    with pytest.raises(KeyError):
        thw.get_cluster("nope")


# ---------------------------------------------------------------------------
# Kernel wrappers under autograd
# ---------------------------------------------------------------------------


def _kernel_cases():
    g = torch.Generator().manual_seed(9)

    def r(*s):
        return torch.randn(*s, generator=g)

    pos = torch.tensor([5, 9], dtype=torch.int32)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return {
        "flash_attention": (fa_k.flash_attention,
                            (r(2, 4, 9, 64), r(2, 2, 9, 64), r(2, 2, 9, 64)),
                            dict(scale=0.125)),
        "decode_attention": (dec_k.decode_attention,
                             (r(2, 4, 64), r(2, 2, 12, 64), r(2, 2, 12, 64),
                              pos), dict(scale=0.125)),
        "paged_decode_attention": (dec_k.paged_decode_attention,
                                   (r(2, 4, 64), r(4, 2, 8, 64),
                                    r(4, 2, 8, 64), table, pos),
                                   dict(scale=0.125)),
        "ssd_scan": (ssd_k.ssd_scan,
                     (r(1, 2, 16, 8), torch.rand(1, 2, 16, generator=g),
                      -torch.rand(2, generator=g), r(1, 16, 4), r(1, 16, 4)),
                     dict(chunk=8)),
    }


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention",
                                "paged_decode_attention", "ssd_scan"])
def test_kernel_wrapper_refuses_autograd(op):
    fn, args, kw = _kernel_cases()[op]
    launches = fn.launches
    want = fn(*args, **kw)  # inputs that do not require grad: the serving case
    grad_args = [a.clone().requires_grad_() if a.is_floating_point() else a
                 for a in args]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args, **kw)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            got = fn(*grad_args, **kw)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fn.launches == launches  # CPU tensors: the plain versions


def test_training_through_the_kernel_impl_raises():
    _, tcfg = _cfgs()
    tp = tcommon.materialize(TM.model_specs(tcfg), 0, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    step = build_train_step(tcfg, RunConfig(attn_impl="kernel", remat="none"),
                            topt.OptConfig())
    with pytest.raises(RuntimeError, match="no backward"):
        step(tp, topt.init_state(topt.OptConfig(), tp), batch)
    # serving's forward (no parameter requires grad) still runs the kernel path
    logits, _, _ = TM.forward(tp, batch, tcfg, RunConfig(attn_impl="kernel"))
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# Session and launcher
# ---------------------------------------------------------------------------


def _jax_measured_keys(dp: int):
    keys = set(jloop.TrainResult([1.0], [jpipe.StepTimes()], 1.0).summary())
    keys.add("metrics")
    if dp:
        keys.add("sync")
    return keys


def test_session_train_single_device_returns_jax_keys():
    spec = JobSpec(arch="granite-3-2b", steps=3, batch=4, seq=16,
                   log_every=0)
    rep = Session(spec, device="cpu").train()
    assert rep.kind == "train"
    assert set(rep.measured) == _jax_measured_keys(0)
    assert rep.measured["steps"] == 3
    assert np.isfinite(rep.measured["losses"]).all()
    assert rep.measured["metrics"]["counters"]["train/steps"] == 3
    assert rep.meta["device"]["type"] == "cpu"
    assert Session(spec, device="cpu").bench().kind == "bench"


@pytest.mark.parametrize("kw", [
    dict(use_planner=True), dict(tune=True), dict(pipe=2),
    dict(dp=2, sync="all_reduce", staleness=1),
    dict(dp=2, sync="all_reduce", backup_workers=1),
    dict(dp=2, sync="all_reduce", ckpt_dir="ckpt"),
    dict(dp=2, sync="all_reduce", use_planner=True),
    dict(ckpt_dir="ckpt"), dict(dp=2)])  # dp > 0 with sync="auto"
def test_options_not_ported_raise(kw):
    spec = JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=8, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Session(spec, device="cpu").train()


def test_modules_refuse_options_not_ported():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.train(tcfg, RunConfig(), topt.OptConfig(), batch=2, seq=8,
                    steps=1, device="cpu", ckpt_dir="ckpt")
    tr = DataParallelTrainer(tcfg, RunConfig(), topt.OptConfig(),
                             devices=["cpu"], sync_overlap=True)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tr.train(batch=2, seq=8, steps=1, ckpt_dir="ckpt")
    finally:
        tr.close()
    with pytest.raises(ValueError, match="remat"):
        RunConfig(remat="full")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = JobSpec(arch="granite-3-2b", steps=1, batch=2, seq=8)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec, device="cuda")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.train(tcfg, RunConfig(), topt.OptConfig(), batch=2, seq=8,
                    steps=1)


def test_train_launcher_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "granite-3-2b", "--steps", "2", "--batch", "4",
        "--seq", "16", "--device", "cpu"])
    launcher.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kind"] == "train" and np.isfinite(out["loss_first"])
