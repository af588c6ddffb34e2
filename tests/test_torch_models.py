"""The port's model modules against the JAX package's, on the same
parameters (JAX's ``materialize`` output carried over with
``params_from_numpy``) and the same numpy-made inputs.

Config: granite-3-2b reduced, 2 layers (two cycles exercise the stacking),
vocab 256.  Tolerances follow tests/test_kernels.py: fp32 2e-4, bf16 3e-2,
taken relative to each tensor's scale (max |want|): every element is a sum
of terms of about that size, so its rounding error is too.

Whole-model comparisons run at fp32 over both layers, and at bf16 over one
layer.  JAX's init draws the (D,H,hd) projections with fan-in H, so q and k
have std ~8 and the attention scores (std ~64) make the softmax nearly
one-hot; XLA keeps excess precision inside fusions where PyTorch rounds
every bf16 op, and a 1-ulp bf16 difference in the second layer's input then
moves its logits by several percent.  That measures the model's
sensitivity, not the port, so bf16 is held to JAX where the inputs of the
compared layer are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serve.engine import place_prefill_cache as jax_place
from repro_torch.configs.base import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import place_prefill_cache as torch_place

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(dtype="bfloat16", **kw):
    kw = {"vocab_size": 256, "num_layers": 2, "dtype": dtype, **kw}
    return (jax_get_config("granite-3-2b").reduced().replace(**kw),
            get_config("granite-3-2b").reduced().replace(**kw))


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs()
    jp = jcommon.materialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = TOL[dtype]
    err = np.abs(got - want).max()
    bound = tol["atol"] + tol["rtol"] * np.abs(want).max()
    assert err <= bound, f"max |diff| {err} > {bound} ({dtype})"


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _tlayer(tree, i):
    return tcommon.tree_map(lambda a: a[i], tree)


def test_params_carry_over_name_for_name(params):
    jp, tp = params
    jleaves = {jcommon._path_str(p): np.asarray(v) for p, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    tleaves = {tcommon.path_str(p): v for p, v in tcommon.tree_items(tp)}
    assert set(jleaves) == set(tleaves)
    assert "slots/slot0/mixer/wq" in tleaves
    for name, v in jleaves.items():
        np.testing.assert_array_equal(tleaves[name].numpy(), v)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    _close(tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_gqa_forward_and_dense_mlp(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    jmix = _layer(jp["slots"]["slot0"]["mixer"], 1)
    tmix = _tlayer(tp["slots"]["slot0"]["mixer"], 1)
    jout, jc = jattn.gqa_forward(jmix, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                 "attn", impl="dense")
    tout, tc = tattn.gqa_forward(tmix, torch.from_numpy(x),
                                 torch.from_numpy(pos), tcfg, "attn",
                                 impl="dense")
    _close(tout, jout)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    jmlp = _layer(jp["slots"]["slot0"]["mlp"], 0)
    tmlp = _tlayer(tp["slots"]["slot0"]["mlp"], 0)
    _close(tmoe.dense_mlp(tmlp, torch.from_numpy(x)),
           jmoe.dense_mlp(jmlp, jnp.asarray(x)))


def test_slot_forward(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 9, jcfg.d_model)).astype(np.float32)
    pos = np.arange(9)[None].astype(np.int32)
    slot = jcfg.pattern[0]
    jh, jc, _ = jblocks.slot_forward(
        _layer(jp["slots"]["slot0"], 0), jnp.asarray(x), jnp.asarray(pos),
        jcfg, slot, jblocks.RunConfig(attn_impl="dense", remat="none"))
    th, tc, _ = tblocks.slot_forward(
        _tlayer(tp["slots"]["slot0"], 0), torch.from_numpy(x),
        torch.from_numpy(pos), tcfg, tcfg.pattern[0],
        tblocks.RunConfig(attn_impl="dense"))
    _close(th, jh)
    _close(tc["k"], jc["k"])


def test_lm_logits_masks_padded_vocab():
    jcfg, tcfg = _cfgs(vocab_size=250)
    assert tcfg.padded_vocab == 256
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((256, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    want = JM.lm_logits({"embed": jnp.asarray(emb)}, jnp.asarray(h), jcfg)
    got = TM.lm_logits({"embed": torch.from_numpy(emb)}, torch.from_numpy(h),
                       tcfg)
    _close(got, want)
    assert torch.all(got[..., 250:] == -1e30)


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


MODEL_CASES = [("float32", 2), ("bfloat16", 1)]


def _impls_vs_dense(dtype):
    """Port impls held to JAX's ``dense``.  In bf16 JAX's dense rounds the
    attention scores to bf16 (std ~64 here, so +-0.25) where the kernels
    keep them in fp32; the port's ``kernel`` is held to JAX's Pallas
    kernel instead (test_kernel_prefill_matches_jax_pallas)."""
    return ("dense", "kernel") if dtype == "float32" else ("dense",)


def _model(params, dtype, layers):
    """Configs and parameters cut to ``layers`` cycles."""
    jp, tp = params
    jcfg, tcfg = _cfgs(dtype, num_layers=layers)
    jp = dict(jp, slots={"slot0": jax.tree_util.tree_map(
        lambda a: a[:layers], jp["slots"]["slot0"])})
    tp = dict(tp, slots={"slot0": tcommon.tree_map(
        lambda a: a[:layers], tp["slots"]["slot0"])})
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype,layers", MODEL_CASES)
def test_forward_logits_and_caches(params, dtype, layers):
    jcfg, tcfg, jp, tp = _model(params, dtype, layers)
    toks = _tokens(4, 2, 24)
    jl, jc, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                           jblocks.RunConfig(attn_impl="dense", remat="none"),
                           with_cache=True)
    for impl in _impls_vs_dense(dtype):
        tl, tc, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                               tblocks.RunConfig(attn_impl=impl),
                               with_cache=True)
        assert tl.dtype == getattr(torch, dtype)
        _close(tl, jl, dtype)
        for name in ("k", "v"):
            assert tc["slots"]["slot0"][name].shape == \
                jc["slots"]["slot0"][name].shape
            _close(tc["slots"]["slot0"][name], jc["slots"]["slot0"][name],
                   dtype)


@pytest.mark.parametrize("dtype,layers", MODEL_CASES)
def test_kernel_prefill_matches_jax_pallas(params, dtype, layers):
    """The port's ``kernel`` prefill (plain flash on CPU) against JAX's
    ``attn_impl="pallas"`` (the Pallas flash kernel in interpret mode)."""
    jcfg, tcfg, jp, tp = _model(params, dtype, layers)
    toks = _tokens(5, 1, 32)
    jl, jc, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                           jblocks.RunConfig(attn_impl="pallas", remat="none"),
                           with_cache=True)
    tl, tc, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                           tblocks.RunConfig(attn_impl="kernel"),
                           with_cache=True)
    _close(tl, jl, dtype)
    _close(tc["slots"]["slot0"]["k"], jc["slots"]["slot0"]["k"], dtype)


@pytest.mark.parametrize("dtype,layers", MODEL_CASES)
def test_decode_step_logits_and_caches(params, dtype, layers):
    """One decode step on identical (bf16, placed) caches, both port impls
    against JAX ``dense``.  At fp32 the new caches widen to fp32 in both
    packages (JAX's one-hot write promotes the bf16 working cache)."""
    jcfg, tcfg, jp, tp = _model(params, dtype, layers)
    s_max, lengths = 48, np.array([20, 13], np.int32)
    toks = _tokens(6, 2, 20)
    jrun = jblocks.RunConfig(attn_impl="dense", remat="none")
    _, jc, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, jrun,
                          with_cache=True)
    jc = jax_place(jcfg, jc, s_max, 20)
    step = np.array([[7], [250]], np.int32)
    jl, jnc = JM.decode_step(jp, jnp.asarray(step), jnp.asarray(lengths), jc,
                             jcfg, jrun)
    for impl in ("dense", "kernel"):
        tc = tcommon.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.bfloat16), jc)
        tl, tnc = TM.decode_step(tp, torch.from_numpy(step),
                                 torch.from_numpy(lengths), tc, tcfg,
                                 tblocks.RunConfig(attn_impl=impl))
        _close(tl, jl, dtype)
        for name in ("k", "v"):
            got, want = tnc["slots"]["slot0"][name], jnc["slots"]["slot0"][name]
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            _close(got, want, dtype)


def test_place_prefill_cache_pads_and_casts(params):
    jp, tp = params
    jcfg, tcfg = _cfgs("float32")
    toks = _tokens(8, 1, 16)
    _, jc, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                          jblocks.RunConfig(attn_impl="dense", remat="none"),
                          with_cache=True)
    _, tc, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                          tblocks.RunConfig(attn_impl="dense"),
                          with_cache=True)
    jpl, tpl = jax_place(jcfg, jc, 40, 16), torch_place(tcfg, tc, 40, 16)
    got, want = tpl["slots"]["slot0"]["k"], jpl["slots"]["slot0"]["k"]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close(got, want, "bfloat16")


def test_unported_paths_raise():
    """The paths once refused here run now: int8 caches take JAX's specs,
    the three last archs (multi-codebook, image prefix, the sliding-window
    slot) materialize, and a ring cache (shorter than the s_max it was
    placed for) on ``"kernel"`` decodes on the plain path (the layout
    rule, ``attention.decode_impl``).  What stays
    refused: an unknown impl, MLA on the kernels."""
    jcfg, tcfg = _cfgs()
    got = tattn.attn_cache_specs(tcfg, "attn", 1, 1, 8, kv_quant=True)
    want = jattn.attn_cache_specs(jcfg, "attn", 1, 1, 8, kv_quant=True)
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for name, sp in got.items():
        assert (sp.shape, sp.axes, sp.dtype) == (want[name].shape,
                                                 want[name].axes,
                                                 want[name].dtype)
    for arch, leaf in (("musicgen-large", "wq"), ("llava-next-34b", "wq"),
                       ("gemma2-27b", "wq")):
        cfg = get_config(arch).reduced()
        assert leaf in TM.model_specs(cfg)["slots"]["slot0"]["mixer"]
        params = TM.init_params(cfg, 0, "cpu")
        assert params["embed"].shape == TM.model_specs(cfg)["embed"].shape
    with pytest.raises(ValueError):
        tattn.attention(None, None, None, None, None, scale=1.0, impl="pallas")
    # MLA's q/k and v head dims differ: no kernel path, and no fallback
    mla = get_config("minicpm3-4b").reduced()
    mix = tcommon.materialize(tattn.mla_specs(mla, 1), 0, "cpu")
    layer = tcommon.tree_map(lambda a: a[0], mix)
    with pytest.raises(ValueError, match="head dim"):
        tattn.mla_forward(layer, torch.zeros(1, 4, mla.d_model),
                          torch.arange(4)[None], mla, "mla", impl="kernel")
    cache = {"ckv": torch.zeros(1, 8, mla.kv_lora_rank),
             "k_rope": torch.zeros(1, 8, mla.qk_rope_head_dim)}
    with pytest.raises(ValueError, match="head dim"):
        tattn.mla_decode(layer, torch.zeros(1, 1, mla.d_model),
                         torch.tensor([3]), cache, mla, "mla", impl="kernel")
    swa = tcfg.replace(attn_window_override=8, dtype="float32")
    mix = tcommon.materialize(tattn.gqa_specs(swa, 1), 0, "cpu")
    layer = tcommon.tree_map(lambda a: a[0], mix)
    x = torch.randn(1, 1, swa.d_model, generator=torch.Generator().manual_seed(0))
    # (cache length, s_max placed for): a ring is shorter than its s_max
    for s_cache, s_max, want in ((8, 16, "dense"), (8, 8, "kernel"),
                                 (4, 4, "kernel"), (16, 16, "kernel"),
                                 (4, None, "kernel"), (16, None, "kernel")):
        assert tattn.decode_impl("kernel", s_cache, 8, s_max) == want
        assert tattn.decode_impl("dense", s_cache, 8, s_max) == "dense"
        outs = []
        for impl in ("kernel", "dense"):
            cache = {"k": torch.ones(1, s_cache, 2, 64),
                     "v": torch.ones(1, s_cache, 2, 64)}
            outs.append(tattn.gqa_decode(layer, x, torch.tensor([3]), cache,
                                         swa, "attn", impl=impl,
                                         s_max=s_max)[0])
        torch.testing.assert_close(outs[0], outs[1], **TOL["float32"])
    # a window-long cache with no s_max is either layout: "kernel" refuses
    assert tattn.decode_impl("dense", 8, 8, None) == "dense"
    with pytest.raises(ValueError, match="pass s_max"):
        tattn.gqa_decode(layer, x, torch.tensor([3]),
                         {"k": torch.ones(1, 8, 2, 64),
                          "v": torch.ones(1, 8, 2, 64)}, swa, "attn",
                         impl="kernel")
