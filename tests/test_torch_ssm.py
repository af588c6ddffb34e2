"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the same parameters (JAX's
``materialize`` output for reduced mamba2-780m, checked name for name and
shape for shape against the port's ``ssm_specs``) and the same numpy-made
inputs.

At fp32 the two agree to 1e-5 of each tensor's scale.  At bf16 only the
kernel path is held to JAX: ``ssd_chunked`` then rounds the cumsum of the
log decay to bf16 (an ulp of 0.5 at |cl| ~ 100), and XLA keeps excess
precision inside its fusions where PyTorch rounds every op, so the two
``auto`` paths differ by more than the comparison's tolerance although
each follows its own framework's rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.kernels import ssd_scan as ssd_k
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

ARCH = "mamba2-780m"


def _cfgs(dtype="float32"):
    return (jax_get_config(ARCH).reduced().replace(dtype=dtype),
            get_config(ARCH).reduced().replace(dtype=dtype))


def _params():
    """Layer 0 of JAX's reduced mamba2-780m mixer, in both frameworks."""
    jcfg, tcfg = _cfgs()
    jp = jcommon.materialize(jssm.ssm_specs(jcfg, 1), jax.random.PRNGKey(0))
    specs = tssm.ssm_specs(tcfg, 1)
    assert {k: tuple(v.shape) for k, v in jp.items()} == \
        {k: s.shape for k, s in specs.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return ({k: v[0] for k, v in jp.items()}, {k: v[0] for k, v in tp.items()})


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _inputs(seed, B, L, D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, L, D)).astype(np.float32)


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(0)
    B, L, H, P, N = 2, 96, 3, 32, 16
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    b = rng.standard_normal((B, L, N)).astype(np.float32)
    c = rng.standard_normal((B, L, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    for chunk, init in ((32, None), (16, h0), (96, h0)):
        jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk,
                                  h0=None if init is None else jnp.asarray(init))
        ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)),
                                  chunk, h0=None if init is None
                                  else torch.from_numpy(init))
        assert th.dtype == torch.float32 and ty.shape == (B, L, H, P)
        _close(ty, jy, 1e-5)
        _close(th, jh, 1e-5)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(1)
    B, H, P, N = 2, 3, 32, 16
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, N, P), (B, H, P), (B, H), (H,), (B, N), (B, N))]
    arrs[2] = np.abs(arrs[2])
    jy, jh = jssm.ssd_step(*map(jnp.asarray, arrs))
    ty, th = tssm.ssd_step(*map(torch.from_numpy, arrs))
    _close(ty, jy, 1e-6)
    _close(th, jh, 1e-6)


@pytest.mark.parametrize("jax_impl,impl", [("auto", "auto"),
                                           ("pallas", "kernel")])
def test_ssm_forward_then_decode_matches_jax(jax_impl, impl):
    """Prefill through ``ssm_forward`` (JAX ``pallas`` against the port's
    ``kernel``, which on CPU tensors is ``ref.ssd_scan_ref``), then three
    ``ssm_decode`` steps on the returned caches."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    B, L = 2, 64  # two chunks of the reduced config's 32
    x = _inputs(2, B, L, tcfg.d_model)
    pos = np.tile(np.arange(L), (B, 1))
    launches = ssd_k.ssd_scan.launches
    jo, jc = jssm.ssm_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                              impl=jax_impl)
    to, tc = tssm.ssm_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                              tcfg, impl=impl)
    assert ssd_k.ssd_scan.launches == launches  # CPU: the plain version
    _close(to, jo, 1e-5)
    _close(tc["state"], jc["state"], 1e-5)
    _close(tc["conv"], jc["conv"], 0)
    rng = np.random.default_rng(3)
    for step in range(3):
        xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jo, jc = jssm.ssm_decode(jp, jnp.asarray(xt), L + step, jc, jcfg)
        to, tc = tssm.ssm_decode(tp, torch.from_numpy(xt), L + step, tc, tcfg)
        assert to.shape == (B, 1, tcfg.d_model)
        _close(to, jo, 1e-5)
        _close(tc["state"], jc["state"], 1e-5)


def test_ssm_forward_kernel_path_bf16_matches_jax_pallas():
    """bf16 weights and input: the port's kernel path (fp32 inside, as the
    CUDA kernel) against JAX's Pallas path, at the SSD's bf16 tolerance of
    tests/test_kernels.py (rtol 5e-2, atol 1e-1)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params()
    jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = _inputs(4, 1, 64, tcfg.d_model)
    jo, _ = jssm.ssm_forward(jp, jnp.asarray(x, jnp.bfloat16), None, jcfg,
                             impl="pallas")
    to, _ = tssm.ssm_forward(tp, torch.from_numpy(x).to(torch.bfloat16), None,
                             tcfg, impl="kernel")
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                               rtol=5e-2, atol=1e-1)


def test_ssm_inits_and_cache_specs():
    """``materialize`` draws the SSM inits from JAX's ranges: a_log = log
    U[1, 16], dt_bias = softplus^-1 U[1e-3, 0.1]; the cache specs equal
    JAX's."""
    jcfg, tcfg = _cfgs()
    p = tcommon.materialize(tssm.ssm_specs(tcfg, 2), 0, "cpu")
    a = torch.exp(p["a_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(p["dt_bias"].double())
    assert bool(((dt >= 1e-3 - 1e-9) & (dt <= 0.1 + 1e-9)).all())
    again = tcommon.materialize(tssm.ssm_specs(tcfg, 2), 0, "cpu")
    assert torch.equal(again["a_log"], p["a_log"])
    jspecs = jssm.ssm_cache_specs(jcfg, 3, 2)
    tspecs = tssm.ssm_cache_specs(tcfg, 3, 2)
    for k in ("state", "conv"):
        assert (tspecs[k].shape, tspecs[k].axes, tspecs[k].dtype) == \
            (jspecs[k].shape, jspecs[k].axes, jspecs[k].dtype)
    for k, s in jssm.ssm_specs(jcfg, 2).items():
        t = tssm.ssm_specs(tcfg, 2)[k]
        assert (t.shape, t.axes, t.init, t.scale) == \
            (s.shape, s.axes, s.init, s.scale)
