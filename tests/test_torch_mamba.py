"""The Mamba slot in the port against the JAX package, on the CPU:
mamba2-780m (Mamba-2 mixers; at reduced size each with a dense MLP) and
jamba-1.5-large-398b (a cycle of an attention/dense slot and a Mamba/MoE
slot).

Configs are each arch's ``reduced()`` (SSM state 32, head dim 32, chunk
32) at vocab 256 and fp32, two layers, with the same parameters in both
packages (drawn with numpy by JAX's init rule, the SSM inits included,
carried over with ``params_from_numpy``; jamba's attention smoothed as
tests/test_torch_archs.py::_smooth does) and seeded numpy inputs.
Tolerances are tests/test_kernels.py's: fp32 2e-4 of each tensor's scale,
bf16 3e-2 for caches that hold the prefill's bf16-rounded entries.

The serving tests run the port's serve impl (``"kernel"``: on CPU tensors
the scan's plain version ``ref.ssd_scan_ref``, in fp32) against JAX's
``"dense"`` (its plain ``ssd_chunked``).  JAX's continuous engine raises
for a pure-SSM config once a prompt reaches ``block_size`` (ROADMAP,
faults in the reference), so mamba2's longer prompts are held to JAX's
``Engine.generate`` on the bucket-padded prompt with ``lengths=[L]``: what
JAX's continuous engine computes there.  The trainers are held to the
port's own single-stage loop, bitwise (JAX's pipeline bit-identity fails
with the installed jax and is not the oracle).
"""
import functools
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.optim import adamw as jopt
from repro.serve.continuous import ContinuousEngine as JContinuousEngine
from repro.serve.continuous import ContinuousScheduler as JContinuousScheduler
from repro.serve.continuous import _bucket
from repro.serve.engine import BatchScheduler as JBatchScheduler
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import place_prefill_cache as jplace
from repro.serve.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.api.session import serve_attn_impl
from repro_torch.checkpoint import restore
from repro_torch.configs.base import get_config
from repro_torch.distributed.pipeline import PipelineTrainer
from repro_torch.distributed.trainer import DataParallelTrainer
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM
from repro_torch.models.common import path_str, tree_items, tree_map
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import OptConfig, init_state
from repro_torch.serve.continuous import ContinuousEngine, ContinuousScheduler
from repro_torch.serve.engine import BatchScheduler, Engine
from repro_torch.serve.engine import place_prefill_cache as tplace
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.train import loop as tloop

ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JRUN = jblocks.RunConfig(attn_impl="dense", remat="none")
TRUN = tblocks.RunConfig(attn_impl="dense")
TIMEOUT = timedelta(seconds=60)


def _cfgs(arch, **kw):
    kw = {"vocab_size": 256, "dtype": "float32", "num_layers": 2, **kw}
    return (jget_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _init(specs, rng):
    """JAX's init rule (``materialize``) drawn from a numpy generator:
    zeros, ones, A_log = log U[1, 16], dt_bias = softplus^-1 U[1e-3, 0.1],
    else normal with std scale/sqrt(shape[-2])."""
    out = {}
    for k, sp in specs.items():
        if isinstance(sp, dict):
            out[k] = _init(sp, rng)
        elif sp.init in ("zeros", "ones"):
            out[k] = np.full(sp.shape, float(sp.init == "ones"), np.float32)
        elif sp.init == "ssm_a":
            out[k] = np.log(rng.uniform(1.0, 16.0, sp.shape)).astype(
                np.float32)
        elif sp.init == "ssm_dt":
            u = rng.uniform(1e-3, 0.1, sp.shape)
            out[k] = (u + np.log(-np.expm1(-u))).astype(np.float32)
        else:
            fan_in = sp.shape[-2] if len(sp.shape) >= 2 else sp.shape[-1]
            out[k] = (rng.standard_normal(sp.shape) * sp.scale
                      / np.sqrt(fan_in)).astype(np.float32)
    return out


def _smooth(tree):
    """Every attention projection (L, in, heads, out) rescaled by
    sqrt(heads / in) and ``wo`` (L, H, hd, D) by H^-1/2
    (tests/test_torch_archs.py::_smooth); the Mamba leaves have no
    4-d projection and stay JAX's."""
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


@functools.lru_cache(maxsize=None)
def _np_params(arch, num_layers=2):
    jcfg, _ = _cfgs(arch, num_layers=num_layers)
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


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = TOL[dtype] * (1.0 + np.abs(want).max())
    assert err <= bound, f"max |diff| {err} > {bound} ({dtype})"


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _leaves(jtree):
    return dict((tuple(k.key for k in path), v) for path, v in
                jax.tree_util.tree_flatten_with_path(jtree)[0])


# ---------------------------------------------------------------------------
# The model: slots, loss and gradients, decode
# ---------------------------------------------------------------------------


def test_mamba_slots_are_ported_and_dispatch():
    """Both archs pass check_ported; their cache specs are JAX's (the
    Mamba slot's state and conv tail beside jamba's k/v); the Mamba
    mixer runs the scan exactly on the serving impl."""
    for arch in ARCHS:
        for full in (False, True):
            jcfg, tcfg = (c if full else c.reduced() for c in
                          (jget_config(arch), get_config(arch)))
            TM.check_ported(tcfg)
            got = dict(tree_items(TM.cache_specs(tcfg, 2, 64)))
            want = _leaves(JM.cache_specs(jcfg, 2, 64))
            assert set(got) == set(want)
            for path, sp in got.items():
                w = want[path]
                assert (sp.shape, sp.axes, sp.dtype) == (w.shape, w.axes,
                                                         w.dtype), path
        assert serve_attn_impl(get_config(arch)) == "kernel"
    for attn_impl, want in (("kernel", "kernel"), ("dense", "auto"),
                            ("chunked", "auto"), ("auto", "auto")):
        assert tblocks._ssm_impl(tblocks.RunConfig(attn_impl=attn_impl)) \
            == want
    for arch in ("musicgen-large", "llava-next-34b", "gemma2-27b"):
        TM.check_ported(get_config(arch))  # the last three archs: ported


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Two layers at fp32, 64 tokens (two chunks of 32): the loss, its ce
    and aux, and every leaf's gradient (the Mamba leaves, jamba's
    attention, router and experts) against jax.value_and_grad; the port
    with block remat, JAX without."""
    jcfg, tcfg, jp, tp = _both(arch)
    toks = _tokens(1, 2, 64)
    labels = toks.copy()
    labels[:, -5:] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jbatch, jcfg, JRUN), has_aux=True))(jp)
    tloss, tm, tg = build_grad_fn(tcfg, tblocks.RunConfig(
        attn_impl="dense", remat="block"))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})
    _close(tloss, jloss)
    _close(tm["ce"], jm["ce"])
    _close(tm["aux"], jm["aux"])
    assert (float(tm["aux"]) > 0) == (arch != "mamba2-780m")
    want, got = _leaves(jg), dict(tree_items(tg))
    assert set(got) == set(want)
    assert ("slots", "slot0" if arch == "mamba2-780m" else "slot1", "mixer",
            "a_log") in got
    for path, g in got.items():
        _close(g, want[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Prefill of 14 tokens (a length no chunk divides: one chunk of 14),
    its caches placed as the engines place them (the Mamba state and conv
    cast to bf16, the k/v padded), then three decode steps at fp32 over
    the bf16 caches: logits every step, and every cache leaf at the end,
    widened to fp32 as JAX's decode leaves them."""
    jcfg, tcfg, jp, tp = _both(arch)
    B, S, s_max = 2, 14, S_MAX
    toks = _tokens(2, B, S)
    jeng = _jax_engine(arch)  # its compiled prefill and decode
    jl0, jc, _ = jeng._prefill(jp, {"tokens": jnp.asarray(toks)})
    tl0, tc, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            TRUN, with_cache=True)
    _close(tl0, jl0)
    for path, c in _leaves(jc).items():
        _close(dict(tree_items(tc))[path], c)
    jc, tc = jplace(jcfg, jc, s_max, S), tplace(tcfg, tc, s_max, S)
    placed = dict(tree_items(tc))
    for path, c in _leaves(jc).items():
        assert placed[path].dtype == torch.bfloat16
        assert tuple(placed[path].shape) == tuple(c.shape), path
    pos = np.full((B,), S, np.int32)
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = jeng._decode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = TM.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc, tcfg, TRUN)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + 1
    want, got = _leaves(jc), dict(tree_items(tc))
    assert set(got) == set(want)
    for path, c in got.items():
        assert c.dtype == torch.float32
        assert np.asarray(want[path]).dtype == np.float32, path
        _close(c, want[path], "bfloat16")


# ---------------------------------------------------------------------------
# The scan at any prompt length
# ---------------------------------------------------------------------------


def _scan_inputs(seed, B, L, H=3, P=32, N=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(
                np.float32),
            -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32))


@pytest.mark.parametrize("L", [5, 9, 13])
def test_ssd_scan_takes_lengths_not_divisible_by_4(L):
    """ops.ssd_scan at a length below the chunk that the kernels' chunks
    (multiples of 4) do not divide: y and the final state are JAX's
    ssd_chunked (one chunk of L) and the plain scan's at L unpadded; the
    padded rows are dropped.  Past the chunk, a length the chunk does not
    divide raises, as JAX asserts."""
    arrs = _scan_inputs(L, 2, L)
    launches = ssd_k.ssd_scan.launches
    ty, th = kops.ssd_scan(*map(torch.from_numpy, arrs), chunk=32)
    assert ssd_k.ssd_scan.launches == launches  # CPU: the plain version
    assert ty.shape == (2, L, 3, 32) and th.dtype == torch.float32
    jy, jh = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, arrs), 32)
    _close(ty, jy, "float32")
    _close(th, jh, "float32")
    x, dt, a, b, c = map(torch.from_numpy, arrs)
    wy, wh = ssd_k.ref.ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), a,
                                    b, c, chunk=32)
    torch.testing.assert_close(ty, wy.transpose(1, 2), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(th, wh, rtol=1e-5, atol=1e-5)
    arrs = _scan_inputs(L, 1, 32 + L)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        kops.ssd_scan(*map(torch.from_numpy, arrs), chunk=32)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, arrs), 32)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lengths]


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


S_MAX = 48


@functools.lru_cache(maxsize=None)
def _jax_engine(arch):
    """One JAX static engine an arch (s_max 48): its compiled steps serve
    the decode test, the static engine test and the oracle alike."""
    jcfg, _, jp, _ = _both(arch)
    return JEngine(jcfg, JRUN, jp, s_max=S_MAX)


def _engines(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    run = tblocks.RunConfig(attn_impl=serve_attn_impl(tcfg))
    return jcfg, tcfg, jp, tp, run


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_tokens_match_jax(arch):
    """Two ragged batches (right-padded, so a shorter row's Mamba state
    takes in its pad tokens, as JAX's does): every request's greedy
    tokens are JAX's."""
    jcfg, tcfg, jp, tp, run = _engines(arch)
    prompts = _prompts(3, (9, 14, 14, 6))  # one prefill shape: (2, 14)
    tsched = BatchScheduler(Engine(tcfg, run, tp, s_max=S_MAX, device="cpu"),
                            max_batch=2)
    jsched = JBatchScheduler(_jax_engine(arch), max_batch=2)
    _run_both(tsched, jsched, prompts, (4, 3, 4, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_tokens_and_pool_match_jax(arch):
    """Continuous batching over the paged pool (block 16), 3 requests on
    2 rows, a retirement and an admission between decode steps: tokens
    and PagedKVCache.stats() equal JAX's.  Prompts stay below
    ``block_size`` for mamba2, where JAX's engine runs; jamba's fill a
    block (published), all in one prefill bucket."""
    jcfg, tcfg, jp, tp, run = _engines(arch)
    lengths = (9, 15, 12) if arch == "mamba2-780m" else (9, 16, 12)
    prompts = _prompts(4, lengths)
    teng = ContinuousEngine(tcfg, run, tp, s_max=48, max_batch=2,
                            device="cpu")
    tkv = PagedKVCache(tcfg, block_size=16, n_blocks=8, s_max=48,
                       device="cpu")
    jeng = JContinuousEngine(jcfg, JRUN, jp, s_max=48, max_batch=2)
    # the same functions as the static engine's, compiled once
    jeng._prefill, jeng._decode = (_jax_engine(arch)._prefill,
                                   _jax_engine(arch)._decode)
    jkv = JPagedKVCache(jcfg, block_size=16, n_blocks=8, s_max=48)
    _run_both(ContinuousScheduler(teng, tkv), JContinuousScheduler(jeng, jkv),
              prompts, (3, 5, 4))
    assert tkv.stats() == jkv.stats()
    assert (tkv.stats()["block_bytes"] == 0) == (arch == "mamba2-780m")
    assert not tkv._states and not tkv._tables  # every request released


def test_pure_ssm_long_prompts_match_jax_generate():
    """mamba2 prompts past ``block_size``, where JAX's continuous engine
    raises (IndexError: it publishes blocks of an empty table).  The
    port's engine publishes nothing and serves them; each request's
    tokens are JAX's Engine.generate on the prompt padded to its bucket
    with lengths=[L], the computation JAX's continuous prefill makes."""
    jcfg, tcfg, jp, tp, run = _engines("mamba2-780m")
    prompts = _prompts(5, (20, 27))
    n_new = (4, 3)
    jkv = JPagedKVCache(jcfg, block_size=16, n_blocks=8, s_max=48)
    jkv.admit(0, prompts[0], 24)
    zeros = jax.tree_util.tree_map(lambda sp: np.zeros(sp.shape, np.float32),
                                   JM.cache_specs(jcfg, 1, 48))
    with pytest.raises(IndexError):  # what JAX's activation of it raises
        jkv.write_prefill(0, zeros, 20)
    teng = ContinuousEngine(tcfg, run, tp, s_max=48, max_batch=2,
                            device="cpu")
    tkv = PagedKVCache(tcfg, block_size=16, n_blocks=8, s_max=48,
                       device="cpu")
    tsched = ContinuousScheduler(teng, tkv)
    for p, n in zip(prompts, n_new):
        tsched.submit(p, n)
    got = tsched.run()
    jeng = _jax_engine("mamba2-780m")
    for rid, (p, n) in enumerate(zip(prompts, n_new)):
        padded = np.zeros((1, _bucket(len(p), 48)), np.int32)
        padded[0, :len(p)] = p
        want = jeng.generate(padded, n, lengths=np.array([len(p)], np.int32))
        np.testing.assert_array_equal(np.asarray(got[rid]), want.tokens[0])
    assert tkv.stats()["used_blocks"] == tkv.stats()["peak_blocks"] == 0


def test_paged_pool_keeps_state_per_request():
    """The state leaves through the pool: write_prefill stores each
    request's bf16 state, commit_token its new state (rounded to bf16, as
    JAX's gather rounds it), gather_batch zero-fills a free row; and a
    chunked prefill is whole-prompt here (``supports_extend`` is false),
    as in JAX's engine."""
    _, tcfg = _cfgs("mamba2-780m")
    kv = PagedKVCache(tcfg, block_size=4, n_blocks=2, s_max=16,
                      device="cpu")
    specs = TM.cache_specs(tcfg, 1, 16)
    assert kv.can_admit(np.arange(12), 16)  # no block to reserve
    g = torch.Generator().manual_seed(0)
    for rid in (0, 1):
        kv.admit(rid, np.arange(12), 16)
        tree = tree_map(lambda sp: torch.randn(sp.shape, generator=g), specs)
        kv.write_prefill(rid, tree, 12)
        assert torch.equal(kv._states[rid][("slots", "slot0", "state")],
                           tree["slots"]["slot0"]["state"][:, 0].to(
                               torch.bfloat16))
    out = kv.gather_batch([1, None, 0])
    st = out["slots"]["slot0"]["state"]
    assert st.dtype == torch.bfloat16 and st.shape[1] == 3
    assert not st[:, 1].any()
    assert torch.equal(st[:, 0], kv._states[1][("slots", "slot0", "state")])
    work = tree_map(lambda a: a.float() * 3, out)
    kv.commit_token([1, 0], [0, 2], [12, 12], work)
    assert torch.equal(kv._states[0][("slots", "slot0", "conv")],
                       work["slots"]["slot0"]["conv"][:, 2].to(
                           torch.bfloat16))
    assert kv.stats()["block_bytes"] == 0 and kv.alloc.n_used == 0
    # chunked prefill is attention-only: a Mamba stack quietly takes
    # whole-prompt prefill, as JAX's engine does
    eng = ContinuousEngine(tcfg, tblocks.RunConfig(), _np_params_t(tcfg),
                           prefill_chunk=8, device="cpu")
    assert eng.prefill_chunk == 0
    assert not TM.supports_extend(tcfg)
    with pytest.raises(NotImplementedError, match="attention-only"):
        TM.extend_step(eng.params, torch.zeros(1, 8, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       eng.empty_caches(1), tcfg, tblocks.RunConfig())


def _np_params_t(tcfg):
    return params_from_numpy(_np_params("mamba2-780m"), tcfg, "cpu")


# ---------------------------------------------------------------------------
# Checkpoints and the trainers
# ---------------------------------------------------------------------------


def _bits(a):
    return np.ascontiguousarray(_np(a) if isinstance(a, torch.Tensor)
                                else np.asarray(a)).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(tmp_path, writer):
    """jamba's params and AdamW state (the Mamba leaves among them) saved
    by one package restore in the other bit for bit, and the reader's loss
    on them is the writer's at fp32 2e-4."""
    jcfg, tcfg, jp, tp = _both("jamba-1.5-large-398b")
    ck = str(tmp_path / "ck")
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    toks = _tokens(6, 2, 32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if writer == "port":  # two steps of the port's loop, saved at step 2
        tloop.train(tcfg, TRUN, opt, batch=2, seq=32, steps=2, device="cpu",
                    log_every=0, params=tp, ckpt_dir=ck, ckpt_every=2)
        written = tp
    else:
        jstate = jopt.init_state(jopt.OptConfig(lr=1e-3, warmup_steps=0), jp)
        jckpt.save({"params": jp, "opt_state": jstate}, ck, step=2)
        written = jp
    template = {"params": tree_map(torch.zeros_like, tp),
                "opt_state": init_state(opt, tp)}
    tout, step = restore(template, ck)  # raises on a missing key
    jtemplate = {"params": jax.tree_util.tree_map(jnp.zeros_like, jp),
                 "opt_state": jopt.init_state(
                     jopt.OptConfig(lr=1e-3, warmup_steps=0), jp)}
    jout, jstep = jckpt.restore(jtemplate, ck)
    assert step == jstep == 2
    got = dict(tree_items(tout["params"]))
    assert ("slots", "slot1", "mixer", "conv_w") in got
    want = (dict(tree_items(written)) if writer == "port"
            else _leaves(written))
    jgot = _leaves(jout["params"])
    for path, w in want.items():
        assert _bits(got[path]) == _bits(w) == _bits(jgot[path]), path
    tloss, _ = TM.loss_fn(tout["params"], batch, tcfg, TRUN)
    jloss, _ = _jax_loss(jcfg)(jout["params"], jnp.asarray(toks))
    _close(tloss, jloss)


@functools.lru_cache(maxsize=None)
def _jax_loss(jcfg):
    """JAX's loss over tokens as labels, compiled once a config."""
    return jax.jit(lambda p, t: JM.loss_fn(p, {"tokens": t, "labels": t},
                                           jcfg, JRUN))


BATCH, SEQ, MICRO = 4, 32, 2


def test_trainers_are_bitwise_the_single_stage_loop():
    """On reduced jamba with two cycles, 2 steps at fp32: the loop (run
    microbatch 2), the data-parallel trainer at dp 1 on the same rows and
    the 1F1B PipelineTrainer at pipe 2 (2 microbatches, one cycle and one
    shard a stage) end with the same params, bit for bit, and the same
    losses."""
    _, tcfg = _cfgs("jamba-1.5-large-398b", num_layers=4)
    p0 = params_from_numpy(_np_params("jamba-1.5-large-398b", num_layers=4),
                           tcfg, "cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    run = tblocks.RunConfig(attn_impl="dense", remat="block",
                            microbatch=BATCH // MICRO)
    kw = dict(batch=BATCH, seq=SEQ, steps=2, seed=0, log_every=0)
    p_loop = tree_map(torch.clone, p0)
    loop = tloop.train(tcfg, run, opt, device="cpu", params=p_loop, **kw)
    dp = DataParallelTrainer(tcfg, run, opt, devices=["cpu"],
                             group_timeout=TIMEOUT)
    pt = PipelineTrainer(tcfg, tblocks.RunConfig(attn_impl="dense",
                                                 remat="block"), opt,
                         pipe=2, n_microbatch=MICRO, devices=["cpu"] * 2,
                         group_timeout=TIMEOUT)
    try:
        res_dp = dp.train(params=tree_map(torch.clone, p0), **kw)
        res_pt = pt.train(params=tree_map(torch.clone, p0), **kw)
    finally:
        dp.close()
        pt.close()
    assert tuple(pt.stage_cut) == (0, 1, 2)
    assert res_dp.losses == loop.losses == res_pt.losses
    want = dict(tree_items(p_loop))
    for got in (dp.params[0], pt.params):
        got = dict(tree_items(got))
        assert list(got) == list(want)
        for path, w in want.items():
            assert torch.equal(got[path], w), path_str(path)
