"""The last three architectures and the serving options they brought, in
the port against the JAX package, on the CPU: gemma2-27b (the sliding-
window slot, post-norms, scaled embedding, attention and logit softcaps),
musicgen-large (four codebooks) and llava-next-34b (the image prefix);
chunked prefill (``extend_step`` and the scheduler's chunk a tick), int8
KV caches and sampled decoding.

Configs are each arch's ``reduced()`` (gemma2's window 64) at vocab 256,
fp32 and two layers, with the same parameters in both packages (drawn
with numpy by JAX's init rule, attention smoothed as
tests/test_torch_archs.py::_smooth does, carried over with
``params_from_numpy``) and seeded numpy inputs.  Tolerances are
tests/test_kernels.py's: fp32 2e-4 of each tensor's scale.  The serving
tests run the port's serve impl (``"kernel"``: on CPU tensors the
kernels' plain versions) against JAX's ``"dense"``.  JAX's compiled steps
are shared through cached engines.
"""
import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.serve.continuous import ContinuousEngine as JContinuousEngine
from repro.serve.continuous import ContinuousScheduler as JContinuousScheduler
from repro.serve.engine import BatchScheduler as JBatchScheduler
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import place_prefill_cache as jplace
from repro.serve.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.api.session import serve_attn_impl
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM
from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import MetricsRegistry
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve.continuous import ContinuousEngine, ContinuousScheduler
from repro_torch.serve.engine import BatchScheduler, Engine, sample
from repro_torch.serve.engine import place_prefill_cache as tplace
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.train import loop as tloop

ARCHS = ("gemma2-27b", "musicgen-large", "llava-next-34b")
TOL = 2e-4
JRUN = jblocks.RunConfig(attn_impl="dense", remat="none")
TRUN = tblocks.RunConfig(attn_impl="dense")
# s_max of each arch's serving tests: gemma2's exceeds its window of 64,
# so the static engine's swa buffers are rings that wrap
S_MAX = {"gemma2-27b": 96, "musicgen-large": 48, "llava-next-34b": 48}


def _cfgs(arch, **kw):
    kw = {"vocab_size": 256, "dtype": "float32", "num_layers": 2, **kw}
    return (jget_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _init(specs, rng):
    """JAX's init rule (``materialize``) drawn from a numpy generator."""
    out = {}
    for k, sp in specs.items():
        if isinstance(sp, dict):
            out[k] = _init(sp, rng)
        elif sp.init in ("zeros", "ones"):
            out[k] = np.full(sp.shape, float(sp.init == "ones"), np.float32)
        else:
            fan_in = sp.shape[-2] if len(sp.shape) >= 2 else sp.shape[-1]
            out[k] = (rng.standard_normal(sp.shape) * sp.scale
                      / np.sqrt(fan_in)).astype(np.float32)
    return out


def _smooth(tree):
    """Every attention projection (L, in, heads, out) rescaled by
    sqrt(heads / in) and ``wo`` (L, H, hd, D) by H^-1/2; the post-norm
    scales drawn away from 0 so they act."""
    out = {}
    for k, v in tree.items():
        if k == "mixer":
            out[k] = {n: (a * a.shape[1] ** -0.5 if n == "wo" else
                          a * (a.shape[2] / a.shape[1]) ** 0.5) for n, a in
                      v.items()}
        elif isinstance(v, dict):
            out[k] = _smooth(v)
        elif k.endswith("post_norm"):
            out[k] = v + 0.5
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    jcfg, _ = _cfgs(arch)
    return _smooth(_init(JM.model_specs(jcfg), np.random.default_rng(0)))


def _both(arch):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(arch)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, npp),
            params_from_numpy(npp, tcfg, "cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = tol * (1.0 + np.abs(want).max())
    assert err <= bound, f"max |diff| {err} > {bound}"


def _tokens(cfg, seed, B, S):
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _images(cfg, seed, B):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _leaves(jtree):
    return dict((tuple(k.key for k in path), v) for path, v in
                jax.tree_util.tree_flatten_with_path(jtree)[0])


@functools.lru_cache(maxsize=None)
def _jax_engine(arch):
    """One JAX static engine an arch: its compiled prefill and decode serve
    the decode test, the static and continuous engine tests alike."""
    jcfg, _, jp, _ = _both(arch)
    return JEngine(jcfg, JRUN, jp, s_max=S_MAX[arch])


def _serve_run(tcfg):
    return tblocks.RunConfig(attn_impl=serve_attn_impl(tcfg))


# ---------------------------------------------------------------------------
# The model: parameters, loss and gradients, decode
# ---------------------------------------------------------------------------


def test_params_from_numpy_carries_the_last_three_archs():
    """musicgen's (K,V,D) embedding and (K,D,V) head, llava's untied head
    and gemma2's post-norm leaves cross packages name for name; the slot
    kinds and cache specs are JAX's."""
    shapes = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        tp = params_from_numpy(_np_params(arch), tcfg, "cpu")
        got = {p: tuple(a.shape) for p, a in tree_items(tp)}
        want = {p: tuple(sp.shape) for p, sp in
                _leaves(JM.model_specs(jcfg)).items()}
        assert got == want
        shapes[arch] = got
        cgot = dict(tree_items(TM.cache_specs(tcfg, 2, 96)))
        for path, sp in _leaves(JM.cache_specs(jcfg, 2, 96)).items():
            assert cgot[path].shape == sp.shape, path
    K, V, D = 4, 256, 256
    assert shapes["musicgen-large"][("embed",)] == (K, V, D)
    assert shapes["musicgen-large"][("lm_head",)] == (K, D, V)
    assert shapes["llava-next-34b"][("lm_head",)] == (D, V)
    assert ("slots", "slot0", "mixer_post_norm") in shapes["gemma2-27b"]
    assert ("slots", "slot1", "mlp_post_norm") in shapes["gemma2-27b"]
    _, tcfg = _cfgs("musicgen-large")
    bad = dict(_np_params("musicgen-large"), embed=np.zeros((V, D)))
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Two layers at fp32, 24 tokens (llava: after its 8-token image
    prefix, whose positions carry no label): the loss and every leaf's
    gradient against jax.value_and_grad; the port with block remat, JAX
    without.  (The forward logits are held in the decode test.)"""
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(tcfg, 1, 2, 24)
    labels = toks.copy()
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    if tcfg.num_image_tokens:
        batch["image_embeds"] = _images(tcfg, 1, 2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jcfg, JRUN), has_aux=True))(jp)
    tloss, tm, tg = build_grad_fn(tcfg, tblocks.RunConfig(
        attn_impl="dense", remat="block"))(tp, tbatch)
    _close(tloss, jloss)
    _close(tm["ce"], jm["ce"])
    want, got = _leaves(jg), dict(tree_items(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        _close(g, want[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """A prefill (gemma2: 70 tokens, past its window; llava: 14 after the
    image prefix): the forward's logits ((B, S, 4, V) for musicgen), its
    caches placed as the static engine places them (gemma2's swa slot
    folded into a 64-slot ring), then three decode steps: the port on its
    serve impl, JAX on dense; logits each step and every cache leaf at
    the end."""
    jcfg, tcfg, jp, tp = _both(arch)
    S = 70 if arch == "gemma2-27b" else 14
    toks = _tokens(tcfg, 2, 2, S)
    batch = {"tokens": toks}
    if tcfg.num_image_tokens:
        batch["image_embeds"] = _images(tcfg, 2, 2)
    n_img = tcfg.num_image_tokens
    jeng = _jax_engine(arch)
    jl0, jc, _ = jeng._prefill(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tl0, tc, _ = TM.forward(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tcfg, TRUN,
                            with_cache=True)
    assert tl0.shape == (2, S + tcfg.num_image_tokens) + (
        (4, 256) if tcfg.num_codebooks else (256,))
    _close(tl0, jl0)
    s_max = S_MAX[arch]
    jc, tc = jplace(jcfg, jc, s_max, S + n_img), tplace(tcfg, tc, s_max,
                                                         S + n_img)
    if arch == "gemma2-27b":
        assert tc["slots"]["slot0"]["k"].shape[2] == 64  # the ring
        assert tc["slots"]["slot1"]["k"].shape[2] == s_max
    run = _serve_run(tcfg)
    pos = np.full((2,), S + n_img, np.int32)
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = jeng._decode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc, tcfg, run, s_max)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    want, got = _leaves(jc), dict(tree_items(tc))
    assert set(got) == set(want)
    for path, c in got.items():
        _close(c, want[path], 3e-2)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    k = cfg.num_codebooks
    return [rng.integers(0, 256, (n, k) if k else (n,)).astype(np.int32)
            for n in lengths]


def _run_both(tsched, jsched, prompts, n_new):
    for p, n in zip(prompts, n_new):
        tsched.submit(p, n)
        jsched.submit(p, n)
    got, want = tsched.run(), jsched.run()
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]), err_msg=rid)
    return got


# each batch's longest prompt is the decode test's S: one prefill shape
STATIC_LENGTHS = {"gemma2-27b": (70, 66, 70, 12),
                  "musicgen-large": (9, 14, 14, 6),
                  "llava-next-34b": (9, 14, 14, 6)}


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_tokens_match_jax(arch):
    """Two ragged batches through the BatchScheduler: every request's
    greedy tokens are JAX's (musicgen's (n_new, 4) per request; gemma2's
    swa rings wrap: its prompts of 66 and 70 pass the window)."""
    jcfg, tcfg, jp, tp = _both(arch)
    prompts = _prompts(tcfg, 3, STATIC_LENGTHS[arch])
    tsched = BatchScheduler(Engine(tcfg, _serve_run(tcfg), tp,
                                   s_max=S_MAX[arch], device="cpu"),
                            max_batch=2)
    jsched = JBatchScheduler(_jax_engine(arch), max_batch=2)
    got = _run_both(tsched, jsched, prompts, (4, 3, 4, 2))
    if tcfg.num_codebooks:
        assert got[0].shape == (4, 4)


def test_llava_generate_with_image_matches_jax():
    """Engine.generate with image_embeds: the caches placed at S + n_img,
    the first token from position lengths - 1 + n_img, decode from
    lengths + n_img (ragged rows), as JAX's."""
    jcfg, tcfg, jp, tp = _both("llava-next-34b")
    prompts = np.zeros((2, 14), np.int32)
    prompts[0] = _tokens(tcfg, 4, 1, 14)[0]
    prompts[1, :9] = _tokens(tcfg, 5, 1, 9)[0]
    lengths = np.array([14, 9], np.int32)
    img = _images(tcfg, 4, 2)
    want = _jax_engine("llava-next-34b").generate(
        prompts, 5, lengths=lengths, image_embeds=img)
    eng = Engine(tcfg, _serve_run(tcfg), tp, s_max=48, device="cpu")
    got = eng.generate(prompts, 5, lengths=lengths, image_embeds=img)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert not np.array_equal(got.tokens, eng.generate(
        prompts, 5, lengths=lengths).tokens)  # the prefix matters


@pytest.mark.parametrize("s_max,mode,per_step", [
    (64, "static", 2), (96, "static", 1), (64, "continuous", 2),
    (96, "continuous", 2)])
def test_swa_decode_route_follows_the_cache_layout(monkeypatch, s_max, mode,
                                                   per_step):
    """gemma2 (one swa and one global layer, window 64) on "kernel": B2's
    wrapper takes every linear cache, the static engine's at s_max ==
    window and the paged working cache at any s_max; only the static
    engine's ring (s_max 96 > window) decodes on "dense", so B2 runs once
    a step there."""
    from repro_torch.kernels import ops as kops
    _, tcfg, _, tp = _both("gemma2-27b")
    calls = []
    plain = kops.decode_attention
    monkeypatch.setattr(kops, "decode_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    prompt = _prompts(tcfg, 16, (20,))[0]
    if mode == "static":
        Engine(tcfg, _serve_run(tcfg), tp, s_max=s_max,
               device="cpu").generate(prompt[None], 5)
        steps = 4
    else:
        sched = ContinuousScheduler(
            ContinuousEngine(tcfg, _serve_run(tcfg), tp, s_max=s_max,
                             max_batch=1, device="cpu"),
            PagedKVCache(tcfg, block_size=16, n_blocks=16, s_max=s_max,
                         device="cpu"))
        sched.submit(prompt, 5)
        sched.run()
        steps = sched.stats["engine_steps"]
    assert len(calls) == per_step * steps


CONT_LENGTHS = {"gemma2-27b": (40, 16, 12), "musicgen-large": (9, 16, 12),
                "llava-next-34b": (9, 16, 12)}


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_tokens_and_pool_match_jax(arch):
    """Continuous batching over the paged pool (block 16), 3 requests on 2
    rows: tokens and PagedKVCache.stats() equal JAX's (gemma2's caches
    stay linear at s_max 96 > window: B2's layout)."""
    jcfg, tcfg, jp, tp = _both(arch)
    s_max = S_MAX[arch]
    prompts = _prompts(tcfg, 6, CONT_LENGTHS[arch])
    teng = ContinuousEngine(tcfg, _serve_run(tcfg), tp, s_max=s_max,
                            max_batch=2, device="cpu")
    tkv = PagedKVCache(tcfg, block_size=16, n_blocks=16, s_max=s_max,
                       device="cpu")
    jeng = JContinuousEngine(jcfg, JRUN, jp, s_max=s_max, max_batch=2)
    jeng._prefill, jeng._decode = (_jax_engine(arch)._prefill,
                                   _jax_engine(arch)._decode)
    jkv = JPagedKVCache(jcfg, block_size=16, n_blocks=16, s_max=s_max)
    got = _run_both(ContinuousScheduler(teng, tkv),
                    JContinuousScheduler(jeng, jkv), prompts, (3, 5, 4))
    assert tkv.stats() == jkv.stats()
    if tcfg.num_codebooks:
        assert got[1].shape == (5, 4)


def test_codebook_prefix_keys_cover_whole_positions():
    """A (L, K) prompt's block keys are whole positions: two prompts that
    share their first 8 positions but not the rest share no 16-position
    block (JAX's flattened keys would share it: ROADMAP, faults in the
    reference)."""
    _, tcfg = _cfgs("musicgen-large")
    kv = PagedKVCache(tcfg, block_size=16, n_blocks=8, s_max=48,
                      device="cpu")
    a = _prompts(tcfg, 7, (20,))[0]
    b = a.copy()
    b[8:] += 1
    for rid, p in enumerate((a, b)):
        kv.admit(rid, p, 24)
        kv.write_prefill(rid, tree_map(
            lambda sp: torch.zeros(sp.shape), TM.cache_specs(tcfg, 1, 48)),
            20)
    assert kv.alloc.shared_hits == 0
    kv.admit(2, a, 24)
    assert kv.alloc.shared_hits == 1  # the same prompt shares its block


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def _zero_caches(cfg, s_max, dtype):
    return tree_map(lambda sp: torch.zeros(sp.shape, dtype=dtype),
                    TM.cache_specs(cfg, 1, s_max))


@functools.lru_cache(maxsize=None)
def _jax_extend(arch):
    jcfg = _cfgs(arch)[0]
    return jax.jit(lambda p, t, p0, c: JM.extend_step(p, t, p0, c, jcfg,
                                                      JRUN))


@pytest.mark.parametrize("arch", ("gemma2-27b", "musicgen-large"))
def test_extend_step_matches_jax_and_forward(arch):
    """A 40-token prompt in five chunks of 8 (s_max 64, gemma2's window)
    on fp32 caches: each chunk's logits equal JAX's extend_step and the
    whole-prompt forward's at each of the chunk's positions; the caches
    at the end are JAX's.  (The engine's bf16 caches are held to JAX's
    tokens in the scheduler test below.)"""
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(tcfg, 8, 1, 40)
    full, _, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            TRUN)
    jstep = _jax_extend(arch)
    jc = jax.tree_util.tree_map(lambda sp: jnp.zeros(sp.shape, jnp.float32),
                                JM.cache_specs(jcfg, 1, 64))
    tc = _zero_caches(tcfg, 64, torch.float32)
    for lo in range(0, 40, 8):
        chunk = toks[:, lo:lo + 8]
        pos0 = np.array([lo], np.int32)
        jl, jc = jstep(jp, jnp.asarray(chunk), jnp.asarray(pos0), jc)
        tl, tc = TM.extend_step(tp, torch.from_numpy(chunk),
                                torch.from_numpy(pos0), tc, tcfg, TRUN)
        _close(tl, jl)
        _close(tl, full[:, lo:lo + 8])
    for path, c in _leaves(jc).items():
        _close(dict(tree_items(tc))[path], c)


@pytest.mark.parametrize("s_max,chunk,lengths,n_new,chunks", [
    (64, 8, (40, 20, 7), (4, 3, 5), 5 + 3),
    (60, 16, (50, 20), (8, 5), 4 + 2)])
def test_chunked_scheduler_matches_jax(s_max, chunk, lengths, n_new, chunks):
    """The continuous scheduler with prefill_chunk on gemma2: one chunk a
    tick interleaved with decode; tokens, prefill_chunks and the pool's
    stats equal JAX's; a request no longer than the chunk takes
    whole-prompt prefill.  At s_max 60 the 50-token prompt's last chunk
    of 16 runs to position 63: its pad rows past the cache are dropped,
    as JAX's ``.at[].set`` drops them."""
    jcfg, tcfg, jp, tp = _both("gemma2-27b")
    prompts = _prompts(tcfg, 9, lengths)
    teng = ContinuousEngine(tcfg, _serve_run(tcfg), tp, s_max=s_max,
                            max_batch=2, prefill_chunk=chunk, device="cpu")
    tkv = PagedKVCache(tcfg, block_size=16, n_blocks=16, s_max=s_max,
                       device="cpu")
    jeng = JContinuousEngine(jcfg, JRUN, jp, s_max=s_max, max_batch=2,
                             prefill_chunk=chunk)
    jeng._extend = _jax_extend("gemma2-27b")  # compiled by the test above
    jkv = JPagedKVCache(jcfg, block_size=16, n_blocks=16, s_max=s_max)
    tsched, jsched = ContinuousScheduler(teng, tkv), JContinuousScheduler(
        jeng, jkv)
    _run_both(tsched, jsched, prompts, n_new)
    assert tsched.stats == jsched.stats
    assert tsched.stats["prefill_chunks"] == chunks
    assert tkv.stats() == jkv.stats()
    hist = teng.metrics.histogram("serve/prefill_chunk_s")
    assert hist.count == chunks


def test_chunked_prefill_past_the_window_matches_whole_prompt():
    """gemma2 at s_max 128 > window 64, an 80-token prompt in chunks of
    32.  JAX's chunked cache holds a swa slot's 64 positions, drops 64-79
    (``.at[].set``) and then fails copying the short cache into the pool
    (ValueError: ROADMAP, faults in the reference).  The port's chunked
    cache is linear at s_max, so its tokens equal the whole-prompt tokens
    of both packages."""
    jcfg, tcfg, jp, tp = _both("gemma2-27b")
    prompt = _prompts(tcfg, 10, (80,))[0]

    def jsched(chunk):
        jeng = JContinuousEngine(jcfg, JRUN, jp, s_max=128, max_batch=1,
                                 prefill_chunk=chunk)
        sched = JContinuousScheduler(jeng, JPagedKVCache(
            jcfg, block_size=16, n_blocks=16, s_max=128))
        sched.submit(prompt, 3)
        return sched

    with pytest.raises(ValueError, match="broadcast"):
        jsched(32).run()
    want = jsched(0).run()[0]
    for chunk in (32, 0):
        teng = ContinuousEngine(tcfg, _serve_run(tcfg), tp, s_max=128,
                                max_batch=1, prefill_chunk=chunk,
                                device="cpu")
        sched = ContinuousScheduler(teng, PagedKVCache(
            tcfg, block_size=16, n_blocks=16, s_max=128, device="cpu"))
        sched.submit(prompt, 3)
        np.testing.assert_array_equal(sched.run()[0], want)
        assert sched.stats["prefill_chunks"] == (3 if chunk else 0)


# ---------------------------------------------------------------------------
# int8 KV caches
# ---------------------------------------------------------------------------


def test_quantize_kv_matches_jax():
    x = (np.random.default_rng(11).standard_normal((3, 1, 4, 64)) * 3.0
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-8, values 0
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    tq, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)))


def test_int8_decode_matches_jax():
    """gemma2 at fp32 decoding 12 teacher-forced tokens into int8 caches
    (``kv_quant``; s_max 48) on the serve impl: the logits every step
    within 2e-4, the int8 values exactly JAX's, the scales within 2e-4."""
    jcfg, tcfg, jp, tp = _both("gemma2-27b")
    toks = _tokens(tcfg, 12, 2, 12)
    jc = jax.tree_util.tree_map(
        lambda sp: jnp.zeros(sp.shape, sp.dtype),
        JM.cache_specs(jcfg, 2, 48, kv_quant=True))
    specs = TM.cache_specs(tcfg, 2, 48, kv_quant=True)
    assert specs["slots"]["slot0"]["k"].dtype == "int8"
    tc = tree_map(lambda sp: torch.zeros(sp.shape, dtype={
        "int8": torch.int8, "float32": torch.float32}[sp.dtype]), specs)
    jstep = jax.jit(lambda p, t, pos, c: JM.decode_step(p, t, pos, c, jcfg,
                                                        JRUN))
    run = _serve_run(tcfg)
    for i in range(12):
        pos = np.full((2,), i, np.int32)
        jl, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos),
                       jc)
        tl, tc = TM.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                torch.from_numpy(pos), tc, tcfg, run)
        _close(tl, jl)
    for path, c in _leaves(jc).items():
        got = dict(tree_items(tc))[path]
        if path[-1] in ("k", "v"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(c))
        else:
            _close(got, c)


# ---------------------------------------------------------------------------
# Sampled decoding
# ---------------------------------------------------------------------------


def test_sampling_is_seeded_and_reproducible():
    """generate(greedy=False): one seed gives the same tokens twice, and
    (over a flat distribution) another seed other tokens; greedy stays
    the default."""
    _, tcfg = _cfgs("gemma2-27b")
    params = TM.init_params(tcfg, 0, "cpu")
    eng = Engine(tcfg, _serve_run(tcfg), params, s_max=48, device="cpu")
    prompts = _tokens(tcfg, 13, 2, 8)
    a = eng.generate(prompts, 6, greedy=False, seed=1).tokens
    b = eng.generate(prompts, 6, greedy=False, seed=1).tokens
    np.testing.assert_array_equal(a, b)
    g1 = eng.generate(prompts, 6).tokens
    g2 = eng.generate(prompts, 6, greedy=True, seed=5).tokens
    np.testing.assert_array_equal(g1, g2)
    m = MetricsRegistry()
    flat = torch.zeros(4, 256)
    draws = [sample(flat, m, torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])


def test_sample_one_hot_and_frequencies():
    """One-hot-dominant logits give their argmax; 2048 draws from a fixed
    8-way softmax land within 4 sigma of its probabilities; a row with a
    NaN is counted as ``serve/nonfinite_logit_rows``."""
    m = MetricsRegistry()
    gen = torch.Generator().manual_seed(0)
    peaked = torch.randn(16, 64, generator=gen)
    hot = torch.randint(0, 64, (16,), generator=gen)
    peaked[torch.arange(16), hot] = 1e4
    np.testing.assert_array_equal(sample(peaked, m, gen), hot.numpy())
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    n = 2048
    ids = sample(logits.expand(n, 8), m, gen)
    p = torch.softmax(logits, 0).numpy()
    freq = np.bincount(ids, minlength=8) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * sigma), (freq, p)
    bad = torch.zeros(2, 8)
    bad[1, 3] = float("nan")
    sample(bad, m, gen)
    assert m.counter("serve/nonfinite_logit_rows").value == 1


def test_codebook_sampling_takes_the_argmax():
    """A codebook model takes the argmax per codebook with greedy=False,
    as JAX's ``_sample`` does."""
    _, tcfg, _, tp = _both("musicgen-large")
    eng = Engine(tcfg, _serve_run(tcfg), tp, s_max=48, device="cpu")
    prompts = _tokens(tcfg, 14, 2, 8)
    np.testing.assert_array_equal(
        eng.generate(prompts, 4, greedy=False, seed=3).tokens,
        eng.generate(prompts, 4).tokens)


# ---------------------------------------------------------------------------
# Training with the image prefix
# ---------------------------------------------------------------------------


def test_llava_data_parallel_trainer_splits_the_prefix():
    """The loader gives image_embeds (B, n_img, D) and a shard a rank of
    (B / dp, n_img, D) beside tokens and labels; one step of the
    data-parallel trainer at dp 2 (threaded gloo) lands within 2e-4 of
    the loop's on the same batch."""
    _, tcfg = _cfgs("llava-next-34b")
    loader = tdata.PrefetchLoader(tcfg, 4, 16, device=["cpu", "cpu"],
                                  seed=0)
    b, _ = next(loader)
    loader.close()
    assert [tuple(x.shape) for x in b["image_embeds"]] == [(2, 8, 256)] * 2
    assert [tuple(x.shape) for x in b["tokens"]] == [(2, 16)] * 2
    p0 = params_from_numpy(_np_params("llava-next-34b"), tcfg, "cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=2)
    run = tblocks.RunConfig(attn_impl="dense", remat="block")
    kw = dict(batch=4, seq=16, steps=1, seed=0, log_every=0)
    p_loop = tree_map(torch.clone, p0)
    loop = tloop.train(tcfg, run, opt, device="cpu", params=p_loop, **kw)
    dp = DataParallelTrainer(tcfg, run, opt, devices=["cpu", "cpu"],
                             strategy="all_reduce",
                             group_timeout=timedelta(seconds=60))
    try:
        res = dp.train(params=tree_map(torch.clone, p0), **kw)
    finally:
        dp.close()
    assert abs(res.losses[0] - loop.losses[0]) <= TOL * (1 + loop.losses[0])
    want = dict(tree_items(p_loop))
    for path, got in tree_items(dp.params[0]):
        _close(got, want[path])
