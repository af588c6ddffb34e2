"""Per-architecture smoke tests of the port, the twin of
tests/test_smoke_archs.py: a REDUCED variant of each of the 10 archs
(<= 2-slot pattern, d_model <= 512, <= 4 experts) runs one train step and
one prefill -> decode step on the CPU, on the port alone; shapes,
finiteness, a loss near ln(V), gradients that are finite and not all
zero, and a decode that writes its caches."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch.steps import build_grad_fn
from repro_torch.models import model as M
from repro_torch.models.blocks import RunConfig
from repro_torch.models.common import torch_dtype, tree_items, tree_map

BS, SEQ = 2, 128
RUN = RunConfig(attn_impl="auto", remat="block")


def make_batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (BS, SEQ, cfg.num_codebooks) if cfg.num_codebooks else (BS, SEQ)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(
            (BS, cfg.num_image_tokens, cfg.d_model), generator=g) * 0.02
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 0, "cpu")
    loss, metrics, grads = build_grad_fn(cfg, RUN)(params, make_batch(cfg, 0))
    assert np.isfinite(float(loss)), f"{arch}: non-finite loss"
    # the loss starts near ln(V)
    assert float(metrics["ce"]) < np.log(cfg.vocab_size) + 2.0
    flat = [g for _, g in tree_items(grads)]
    assert all(bool(torch.isfinite(g).all()) for g in flat), f"{arch}: NaN grads"
    assert any(float(g.abs().max()) > 0 for g in flat), f"{arch}: zero grads"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_smoke(arch):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 1, "cpu")
    batch = make_batch(cfg, 1)
    with torch.no_grad():
        logits, _, _ = M.forward(params, batch, cfg, RUN)
    S_total = SEQ + (cfg.num_image_tokens or 0)
    tail = ((cfg.num_codebooks,) if cfg.num_codebooks else ()) + (
        cfg.padded_vocab,)
    assert logits.shape == (BS, S_total) + tail
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())

    # decode one step from an empty cache at pos 0
    caches = tree_map(lambda sp: torch.zeros(sp.shape,
                                             dtype=torch_dtype(sp.dtype)),
                      M.cache_specs(cfg, BS, s_max=64))
    before = tree_map(torch.clone, caches)
    tok = batch["tokens"][:, :1]
    pos = torch.zeros((BS,), dtype=torch.int32)
    with torch.no_grad():
        dlogits, new_caches = M.decode_step(params, tok, pos, caches, cfg,
                                            RUN)
    assert dlogits.shape == (BS, 1) + tail
    assert bool(torch.isfinite(dlogits[..., :cfg.vocab_size]).all())
    # the cache was written
    old = dict(tree_items(before))
    assert any(not torch.equal(c, old[p].to(c.dtype))
               for p, c in tree_items(new_caches)), f"{arch}: cache not updated"
