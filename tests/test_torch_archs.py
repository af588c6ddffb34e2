"""MLA, the capacity-dispatched MoE MLP and the ``first_k_dense`` prelude
in the port against the JAX package, on the CPU: minicpm3-4b (MLA,
dense), deepseek-v2-236b (MLA + MoE with a shared expert after one dense
prelude layer) and arctic-480b (GQA + arctic's parallel dense + MoE).

Configs are each arch's ``reduced()`` (4 experts, top-2), vocab 256, with
the same parameters in both packages (drawn with numpy by JAX's init
rule, carried over with ``params_from_numpy``) and seeded numpy inputs.  Tolerances are
tests/test_kernels.py's, relative to each tensor's scale: fp32 2e-4, bf16
3e-2, with bf16 whole-model comparisons on one layer.  Gradients through
two layers start from smoothed attention (tests/test_torch_train.py::
_smooth): JAX's init makes the attention one-hot.

``moe_mlp`` picks JAX's experts and drops JAX's assignments: the top-k
indices and the keep mask are compared exactly, with a router that
overflows one expert at capacity 1.25, and with tied router
probabilities (``jax.lax.top_k`` puts the lower index first)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serve.continuous import ContinuousEngine as JContinuousEngine
from repro.serve.continuous import ContinuousScheduler as JContinuousScheduler
from repro.serve.engine import BatchScheduler as JBatchScheduler
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import place_prefill_cache as jplace
from repro.serve.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs.base import get_config
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.continuous import ContinuousEngine, ContinuousScheduler
from repro_torch.serve.engine import BatchScheduler, Engine
from repro_torch.serve.engine import place_prefill_cache as tplace
from repro_torch.serve.kvcache import PagedKVCache

ARCHS = ("minicpm3-4b", "deepseek-v2-236b", "arctic-480b")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JRUN = jblocks.RunConfig(attn_impl="dense", remat="none")
TRUN = tblocks.RunConfig(attn_impl="dense")


def _cfgs(arch, dtype="float32", **kw):
    """Both packages' reduced config; two layers unless ``num_layers`` is
    given (deepseek: the prelude layer and one MLA + MoE cycle)."""
    kw = {"vocab_size": 256, "dtype": dtype, "num_layers": 2, **kw}
    return (jget_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _smooth(tree):
    """Every attention projection (L, in, heads, out) rescaled by
    sqrt(heads / in) and ``wo`` (L, H, hd, D) by H^-1/2: std 1/sqrt of
    the whole product's fan-in, where JAX's init takes the head count."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _smooth(v) if k != "mixer" else {
                n: (a * a.shape[1] ** -0.5 if n == "wo" else
                    a * (a.shape[2] / a.shape[1]) ** 0.5 if a.ndim == 4 else a)
                for n, a in v.items()}
        else:
            out[k] = v
    return out


def _init(specs, rng):
    """JAX's init rule (``materialize``: std scale/sqrt(shape[-2]), zeros
    where asked) drawn from a numpy generator: JAX's own draws would
    compile one random op per leaf shape."""
    out = {}
    for k, sp in specs.items():
        if isinstance(sp, dict):
            out[k] = _init(sp, rng)
        elif sp.init == "zeros":
            out[k] = np.zeros(sp.shape, np.float32)
        else:
            fan_in = sp.shape[-2] if len(sp.shape) >= 2 else sp.shape[-1]
            out[k] = (rng.standard_normal(sp.shape) * sp.scale
                      / np.sqrt(fan_in)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _np_params(arch, **kw):
    jcfg, _ = _cfgs(arch, **kw)
    return _smooth(_init(JM.model_specs(jcfg), np.random.default_rng(0)))


def _both(arch, dtype="float32", **kw):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    npp = _np_params(arch, **kw)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_numpy(npp, tcfg, "cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = TOL[dtype] * (1.0 + np.abs(want).max())
    assert err <= bound, f"max |diff| {err} > {bound} ({dtype})"


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The router and the MoE MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_ties_match_jax(dtype, k):
    """Logits from a 4-value grid (ties at the k-th place on most rows):
    the same experts in the same order as jax.lax.top_k, the weights and
    the aux."""
    rng = np.random.default_rng(k)
    logits = (rng.integers(0, 4, (64, 8)) / 4.0).astype(np.float32)
    logits[:4] = 0.0  # all eight experts tied
    jl = jnp.asarray(logits, jnp.dtype(dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jw, jidx, jaux = jmoe._router_topk(jl, k)
    tw, tidx, taux = tmoe._router_topk(tl, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx[:4].numpy(), np.tile(np.arange(k),
                                                            (4, 1)))
    _close(tw, jw)
    _close(taux, jaux)


def _moe_params(case):
    """deepseek-v2 reduced's MoE leaves (one layer, shared expert), as
    numpy.  ``skewed``: expert 0 takes most tokens, so capacity 1.25
    drops; ``tied``: experts 1 and 2 have the same router column, so their
    probabilities tie on every token."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b")
    p = _init(jmoe.moe_specs(jcfg, 1), np.random.default_rng(3))
    p = jax.tree_util.tree_map(lambda a: a[0].copy(), p)
    if case == "skewed":
        p["router"][:, 0] += 0.05  # with inputs of mean 0.5: +6.4 a logit
    if case == "tied":
        p["router"][:, 2] = p["router"][:, 1]
    return jcfg, tcfg, p


def _moe_input(case, seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x + 0.5 if case == "skewed" else x


# JAX's moe_mlp compiled once per (config, capacity, shape); op by op it
# would compile every primitive separately
_jax_moe = jax.jit(jmoe.moe_mlp, static_argnums=2,
                   static_argnames="capacity_factor")


def _jax_keep(p, x, cfg, cf):
    """JAX's moe_mlp assignment and keep mask (its own ops, in flat
    (token, k) order)."""
    T = x.shape[0] * x.shape[1]
    E, K = cfg.num_experts, cfg.top_k
    _, idx, _ = jmoe._router_topk(x.reshape(T, -1) @ p["router"], K)
    C = max(int(cf * T * K / E) + 1, 4)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    pos = jnp.arange(T * K) - jnp.searchsorted(se, jnp.arange(E))[se]
    keep = np.zeros(T * K, bool)
    keep[np.asarray(order)] = np.asarray(pos < C)
    return np.asarray(idx), keep


def _port_keep(p, x, cfg, cf):
    r = tmoe.route(p, x.reshape(-1, x.shape[-1]), cfg, cf)
    keep = torch.zeros_like(r["keep"])
    keep[r["order"]] = r["keep"]
    return r["idx"].numpy(), keep.numpy()


@pytest.mark.parametrize("case", ["plain", "skewed", "tied"])
@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_moe_mlp_matches_jax(case, cf):
    """Output, aux, the top-k indices and the keep mask at capacity 1.25
    and 64 (no drops)."""
    jcfg, tcfg, p = _moe_params(case)
    x = _moe_input(case, 4, (2, 24, jcfg.d_model))
    x[0, :2] = 0.0  # every expert tied on these tokens
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, p)
    jout, jaux = _jax_moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    tout, taux = tmoe.moe_mlp(tp, torch.from_numpy(x), tcfg,
                              capacity_factor=cf)
    _close(tout, jout)
    _close(taux, jaux)
    jidx, jkeep = _jax_keep(jp, jnp.asarray(x), jcfg, cf)
    tidx, tkeep = _port_keep(tp, torch.from_numpy(x), tcfg, cf)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    if case == "skewed":
        assert tkeep.all() == (cf > 1.25)  # expert 0 overflows at 1.25
    if case == "tied":  # expert 1 wins every tie with 2
        rows = (tidx == 2).any(-1)
        assert rows.any() and (tidx[rows] == 1).any(-1).all()
        assert (np.argmax(tidx[rows] == 1, -1)
                < np.argmax(tidx[rows] == 2, -1)).all()


def test_moe_mlp_bf16_matches_jax():
    jcfg, tcfg, p = _moe_params("skewed")
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in (jcfg, tcfg))
    x = _moe_input("skewed", 5, (2, 24, jcfg.d_model))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    jout, jaux = _jax_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, taux = tmoe.moe_mlp(tp, torch.from_numpy(x).to(torch.bfloat16),
                              tcfg)
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, "bfloat16")
    _close(taux, jaux, "bfloat16")


def test_moe_mlp_grads_match_jax():
    """d(sum(out * w) + aux) / d(every leaf, x) at capacity 1.25 with
    drops, against jax.grad."""
    jcfg, tcfg, p = _moe_params("skewed")
    x = _moe_input("skewed", 6, (2, 24, jcfg.d_model))
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jmoe.moe_mlp(pp, xx, jcfg)
        return jnp.sum(out * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    leaves = [(path, torch.from_numpy(a).requires_grad_())
              for path, a in tree_items(p)]
    tx = torch.from_numpy(x).requires_grad_()
    tp = {}
    for path, a in leaves:
        node = tp
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    out, aux = tmoe.moe_mlp(tp, tx, tcfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for path, a in leaves:
        want = jg
        for k in path:
            want = want[k]
        _close(a.grad, want)
    _close(tx.grad, jgx)


def test_moe_mlp_at_large_capacity_is_the_all_experts_reference():
    jcfg, tcfg, p = _moe_params("plain")
    x = np.random.default_rng(7).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    tp = tree_map(torch.from_numpy, p)
    got, _ = tmoe.moe_mlp(tp, torch.from_numpy(x), tcfg, capacity_factor=64)
    _close(got, tmoe.moe_mlp_ref(tp, torch.from_numpy(x), tcfg))
    _close(tmoe.moe_mlp_ref(tp, torch.from_numpy(x), tcfg),
           jax.jit(jmoe.moe_mlp_ref, static_argnums=2)(
               jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_forward_and_decode_match_jax():
    """mla_forward (out and the ckv/k_rope caches) and one absorbed-latent
    mla_decode step against JAX's; the port's decode at position S-1 over
    the first S-1 positions' caches equals its forward at S-1."""
    jcfg, tcfg, jp, tp = _both("minicpm3-4b")
    jmix = jax.tree_util.tree_map(lambda a: a[0],
                                  jp["slots"]["slot0"]["mixer"])
    tmix = tree_map(lambda a: a[0], tp["slots"]["slot0"]["mixer"])
    B, S, s_max = 2, 12, 16
    x = np.random.default_rng(8).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jout, jc = jax.jit(jattn.mla_forward, static_argnums=(3, 4))(
        jmix, jnp.asarray(x), jnp.asarray(pos), jcfg, "mla")
    tout, tc = tattn.mla_forward(tmix, torch.from_numpy(x),
                                 torch.from_numpy(pos), tcfg, "mla")
    _close(tout, jout)
    _close(tc["ckv"], jc["ckv"])
    _close(tc["k_rope"], jc["k_rope"])
    chunked, _ = tattn.mla_forward(tmix, torch.from_numpy(x),
                                   torch.from_numpy(pos), tcfg, "mla",
                                   impl="chunked", kv_block=4, q_block=8)
    _close(chunked, tout)

    def cache_of(c, n):
        return {k: torch.nn.functional.pad(
            v[:, :n], (0, 0, 0, s_max - n)) for k, v in c.items()}

    p_last = np.full((B,), S - 1, np.int32)
    tcache = cache_of(tc, S - 1)
    jcache = {k: jnp.asarray(v.numpy()) for k, v in tcache.items()}
    jd, jnew = jax.jit(jattn.mla_decode, static_argnums=(4, 5))(
        jmix, jnp.asarray(x[:, -1:]), jnp.asarray(p_last), jcache, jcfg,
        "mla")
    td, tnew = tattn.mla_decode(tmix, torch.from_numpy(x[:, -1:]),
                                torch.from_numpy(p_last), tcache, tcfg, "mla")
    _close(td, jd)
    _close(tnew["ckv"], jnew["ckv"])
    _close(tnew["k_rope"], jnew["k_rope"])
    _close(td[:, 0], tout[:, -1])


def test_supports_extend_is_jax_s():
    """Chunked prefill's gate: attention-only GQA stacks; MLA decodes in
    absorbed-latent form, so it takes whole-prompt prefill, as in JAX."""
    for arch in ARCHS + ("granite-3-2b", "mamba2-780m"):
        want = JM.supports_extend(jget_config(arch))
        assert TM.supports_extend(get_config(arch)) == want
    assert not TM.supports_extend(get_config("minicpm3-4b"))


# ---------------------------------------------------------------------------
# The whole model: forward, loss with aux, gradients, decode with prelude
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Two layers at fp32 from smoothed attention: logits, the aux, the
    loss (ce + 0.01 aux) and every leaf's gradient (prelude included)."""
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(9, 2, 16)
    labels = toks.copy()
    labels[:, -3:] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, _, jaux = _jax_forward(jcfg)(jp, jbatch["tokens"])
    tl, _, taux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             TRUN)
    _close(tl, jl)
    _close(taux, jaux)
    moe = arch != "minicpm3-4b"
    assert (float(taux) > 0) == moe
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jcfg, JRUN), has_aux=True))(jp)
    tloss, tm, tg = build_grad_fn(tcfg, tblocks.RunConfig(attn_impl="dense"))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})
    _close(tloss, jloss)
    _close(tm["aux"], jm["aux"])
    _close(tm["ce"], jm["ce"])
    want = dict((tuple(k.key for k in path), v) for path, v in
                jax.tree_util.tree_flatten_with_path(jg)[0])
    got = dict(tree_items(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        _close(g, want[path])


def _jax_forward(jcfg, with_cache=False):
    """JAX's forward over tokens, compiled as its engines compile it."""
    return jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg, JRUN,
                                           with_cache=with_cache))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_one_layer_matches_jax(arch):
    """One layer at bf16 (deepseek's MLA + MoE slot, without the prelude);
    an MoE layer against JAX's forward evaluated op by op
    (``jax.disable_jit``), as the port runs.  Compiled, XLA keeps
    excess precision inside its fusions (the router's input among them),
    and where two router probabilities sit within a bf16 ulp its top-k
    can differ from its own op-by-op evaluation: a flipped expert then
    measures XLA's rounding, not the port."""
    kw = {"first_k_dense": 0} if arch == "deepseek-v2-236b" else {}
    jcfg, tcfg, jp, tp = _both(arch, "bfloat16", num_layers=1, **kw)
    toks = _tokens(10, 2, 16)
    if jcfg.num_experts:
        with jax.disable_jit():
            jl, _, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                     JRUN)
    else:  # no router: compiled and op by op agree to the tolerance
        jl, _, jaux = _jax_forward(jcfg)(jp, jnp.asarray(toks))
    tl, _, taux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             TRUN)
    _close(tl, jl, "bfloat16")
    _close(taux, jaux, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_with_prelude_caches_matches_jax(arch):
    """Prefill (forward with caches, placed into bf16 buffers: the
    prelude's and the MLA ckv/k_rope leaves too), then two decode steps:
    logits and every cache leaf against JAX's at fp32."""
    jcfg, tcfg, jp, tp = _both(arch)
    B, S, s_max = 2, 8, 16
    toks = _tokens(11, B, S)
    _, jc, _ = _jax_forward(jcfg, True)(jp, jnp.asarray(toks))
    _, tc, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, TRUN,
                          with_cache=True)
    jc, tc = jplace(jcfg, jc, s_max, S), tplace(tcfg, tc, s_max, S)
    assert set(tc) == ({"slots", "prelude"} if tcfg.first_k_dense
                       else {"slots"})
    pos = np.full((B,), S, np.int32)
    tok = toks[:, -1:]
    jdecode = jax.jit(lambda p, t, q, c: JM.decode_step(p, t, q, c, jcfg,
                                                        JRUN))
    for step in range(2):
        jl, jc = jdecode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc, tcfg, TRUN)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    # the caches hold the prefill's bf16-rounded entries (widened to fp32
    # by the decode writes, C1), so they are held at bf16
    want = dict((tuple(k.key for k in path), v) for path, v in
                jax.tree_util.tree_flatten_with_path(jc)[0])
    got = dict(tree_items(tc))
    assert set(got) == set(want)
    for path, c in got.items():
        assert c.dtype == torch.float32
        _close(c, want[path], "bfloat16")


def _workload(seed, n_new=(3, 4)):
    """Two ragged prompts in one prefill bucket (9..16 tokens): one batch
    for the static engine, one compile of each JAX step."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (int(rng.integers(9, 17)),))
             .astype(np.int32), n) for n in n_new]


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_greedy_tokens_match_jax(arch):
    """Static and continuous batching at fp32 (the port's serve impl for
    the arch: dense for MLA, the kernels' plain versions for GQA): every
    request's greedy tokens are JAX's, and the paged pool's statistics
    too."""
    from repro_torch.api.session import serve_attn_impl

    jcfg, tcfg, jp, tp = _both(arch)
    run = tblocks.RunConfig(attn_impl=serve_attn_impl(tcfg))
    assert run.attn_impl == ("kernel" if arch == "arctic-480b" else "dense")
    reqs = _workload(12)
    jsched = JBatchScheduler(JEngine(jcfg, JRUN, jp, s_max=32), max_batch=2)
    tsched = BatchScheduler(Engine(tcfg, run, tp, s_max=32, device="cpu"),
                            max_batch=2)
    jeng = JContinuousEngine(jcfg, JRUN, jp, s_max=32, max_batch=2)
    jkv = JPagedKVCache(jcfg, block_size=8, n_blocks=12, s_max=32)
    teng = ContinuousEngine(tcfg, run, tp, s_max=32, max_batch=2,
                            device="cpu")
    tkv = PagedKVCache(tcfg, block_size=8, n_blocks=12, s_max=32,
                       device="cpu")
    jcont, tcont = JContinuousScheduler(jeng, jkv), ContinuousScheduler(teng,
                                                                        tkv)
    for prompt, n_new in reqs:
        for sched in (jsched, tsched, jcont, tcont):
            sched.submit(prompt, n_new)
    for t, j in ((tsched, jsched), (tcont, jcont)):
        got, want = t.run(), j.run()
        assert set(got) == set(want)
        for rid in want:
            np.testing.assert_array_equal(np.asarray(got[rid]),
                                          np.asarray(want[rid]))
    assert tkv.stats() == jkv.stats()
