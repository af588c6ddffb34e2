"""The port's serving runtime against the JAX package's, with the same
parameters (carried over with ``params_from_numpy``) and the same
workload (tests/test_serving.py's style: ragged prompts and n_new).

- fp32 config: every request's greedy token stream is identical, in both
  serve modes and for both port attention impls, and the paged KV cache
  reports the same statistics (peak blocks, shared-prefix hits).
- bf16 config (the serving default): first-token logits agree within the
  bf16 tolerance (3e-2 relative to the logits' scale).
- ``Session.serve()`` on ``device="cpu"`` returns the JAX ``measured`` key
  set and a metrics section that the JAX package's ``validate_metrics``
  accepts; asking for ``cuda`` without a card raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import JobSpec as JaxJobSpec
from repro.api import Session as JaxSession
from repro.configs.base import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import model as JM
from repro.obs import validate_metrics
from repro.serve.continuous import ContinuousEngine as JaxContinuousEngine
from repro.serve.continuous import ContinuousScheduler as JaxContinuousScheduler
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Engine as JaxEngine
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.continuous import (ContinuousEngine, ContinuousScheduler,
                                          _bucket)
from repro_torch.serve.engine import BatchScheduler, Engine
from repro_torch.serve.kvcache import PagedKVCache

JAX_RUN = jblocks.RunConfig(attn_impl="dense", remat="none")


def _cfgs(dtype):
    kw = {"vocab_size": 256, "dtype": dtype}
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs("float32")
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jp, tp


def _workload(seed, n=4, n_new=(1, 4, 2, 3)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (int(rng.integers(8, 24)),))
             .astype(np.int32), n_new[i % len(n_new)]) for i in range(n)]


def _jax_continuous(cfg, params, reqs, *, n_blocks=16):
    eng = JaxContinuousEngine(cfg, JAX_RUN, params, s_max=64, max_batch=2)
    kv = JaxPagedKVCache(cfg, block_size=16, n_blocks=n_blocks, s_max=64)
    sched = JaxContinuousScheduler(eng, kv)
    for prompt, n_new in reqs:
        sched.submit(prompt, n_new)
    return sched.run(), sched, kv


def _torch_continuous(cfg, params, reqs, impl, *, n_blocks=16):
    eng = ContinuousEngine(cfg, tblocks.RunConfig(attn_impl=impl), params,
                           s_max=64, max_batch=2, device="cpu")
    kv = PagedKVCache(cfg, block_size=16, n_blocks=n_blocks, s_max=64,
                      device="cpu")
    sched = ContinuousScheduler(eng, kv)
    for prompt, n_new in reqs:
        sched.submit(prompt, n_new)
    return sched.run(), sched, kv


def _same_streams(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(np.asarray(a[rid]), np.asarray(b[rid]))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_continuous_streams_and_kv_stats_match_jax_fp32(params, impl):
    jp, tp = params
    jcfg, tcfg = _cfgs("float32")
    prompt = np.random.default_rng(6).integers(0, 256, (32,)).astype(np.int32)
    # ragged requests, then two identical prompts that share their blocks
    for reqs in (_workload(3), [(prompt, 3), (prompt, 4)]):
        jres, jsched, jkv = _jax_continuous(jcfg, jp, reqs)
        tres, tsched, tkv = _torch_continuous(tcfg, tp, reqs, impl)
        _same_streams(tres, jres)
        assert tkv.stats() == jkv.stats()
        assert tsched.stats == jsched.stats
    assert tkv.stats()["shared_block_hits"] >= 2


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_static_streams_match_jax_fp32(params, impl):
    jp, tp = params
    jcfg, tcfg = _cfgs("float32")
    reqs = _workload(5)
    jsched = JaxBatchScheduler(JaxEngine(jcfg, JAX_RUN, jp, s_max=64),
                               max_batch=2)
    tsched = BatchScheduler(Engine(tcfg, tblocks.RunConfig(attn_impl=impl), tp,
                                   s_max=64, device="cpu"), max_batch=2)
    for prompt, n_new in reqs:
        jsched.submit(prompt, n_new)
        tsched.submit(prompt, n_new)
    _same_streams(tsched.run(), jsched.run())
    assert tsched.stats == jsched.stats


def test_first_token_logits_bf16(params):
    """At bf16, the bucketed batch-1 prefill's last-position logits: the
    port's dense and kernel impls against JAX's dense and pallas."""
    jp, tp = params
    jcfg, tcfg = _cfgs("bfloat16")
    for prompt, _ in _workload(7):
        L = prompt.shape[0]
        toks = np.zeros((1, _bucket(L, 64)), np.int32)
        toks[0, :L] = prompt
        for jimpl, timpl in (("dense", "dense"), ("pallas", "kernel")):
            jl, _, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  jblocks.RunConfig(attn_impl=jimpl,
                                                    remat="none"))
            tl, _, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                                  tblocks.RunConfig(attn_impl=timpl))
            want = np.asarray(jnp.asarray(jl[0, L - 1], jnp.float32))
            got = tl[0, L - 1].float().numpy()
            bound = 3e-2 + 3e-2 * np.abs(want).max()
            assert np.abs(got - want).max() <= bound, (jimpl, L)


def _keys(d, drop=()):
    return sorted(k for k in d if k not in drop)


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_session_serve_measured_keys_match_jax(mode):
    kw = dict(arch="granite-3-2b", requests=3, n_new=4, s_max=64,
              max_batch=2, serve_mode=mode)
    jm = JaxSession(JaxJobSpec(**kw)).serve().measured
    rep = Session(JobSpec(**kw), device="cpu").serve()
    tm = rep.measured
    assert _keys(tm) == _keys(jm)
    assert _keys(tm["serving"]) == _keys(jm["serving"])
    for sect in ("scheduler", "kv_cache", "latency_s", "throughput", "slo"):
        assert _keys(tm["serving"][sect]) == _keys(jm["serving"][sect])
    assert _keys(tm["serving"]["replica_lemma"]) == \
        _keys(jm["serving"]["replica_lemma"])
    for half in ("predicted", "measured"):
        assert _keys(tm["serving"]["replica_lemma"][half]) == \
            _keys(jm["serving"]["replica_lemma"][half])
    assert _keys(tm["per_request"][0]) == _keys(jm["per_request"][0])
    validate_metrics(tm["metrics"])
    for sect in ("counters", "gauges", "histograms"):
        assert set(jm["metrics"][sect]) <= set(tm["metrics"][sect])
    assert tm["metrics"]["counters"]["serve/nonfinite_logit_rows"] == 0
    assert [r["tokens"] for r in tm["per_request"]] == \
        [r["tokens"] for r in jm["per_request"]]
    assert rep.meta["device"]["type"] == "cpu"


def test_cuda_without_a_card_raises(monkeypatch):
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = JobSpec(arch="granite-3-2b", requests=1, n_new=2, s_max=64)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec).serve()
