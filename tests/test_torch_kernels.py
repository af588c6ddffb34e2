"""The port's kernel plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and its
``repro.kernels.ref`` oracles, on the same numpy-made inputs.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them to the same plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_k

# tests/test_kernels.py's tolerances: fp32 sums in another order; bf16
# inputs and output rounded at other places
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(seed, shapes, dtype):
    """numpy float32 normals, rounded once to ``dtype`` in both frameworks."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,window,cap",
    [
        (2, 128, 4, 4, 64, 0, 0.0),     # MHA
        (1, 96, 8, 2, 64, 0, 0.0),      # GQA, length not a multiple of 64
        (1, 160, 4, 2, 64, 48, 0.0),    # sliding window
        (1, 72, 4, 2, 128, 24, 30.0),   # window + cap + D=128, ragged
    ],
)
def test_flash_plain_matches_pallas_and_ref(B, S, H, KV, D, window, cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    scale = 1.0 / np.sqrt(D)
    before = fa_k.flash_attention.launches
    got = fa_k.flash_attention(tq, tk, tv, scale=scale, window=window, cap=cap)
    assert fa_k.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_flash(jq, jk, jv, scale=scale, window=window, cap=cap,
                       q_block=64, kv_block=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, scale=scale, window=window,
                                      cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,window,cap",
    [
        (3, 256, 4, 4, 64, 0, 0.0),     # MHA
        (4, 300, 8, 2, 64, 0, 0.0),     # GQA, S not a multiple of 64
        (3, 256, 4, 2, 128, 96, 0.0),   # sliding window, D=128
        (3, 200, 8, 2, 64, 0, 30.0),    # tanh cap
    ],
)
def test_decode_plain_matches_pallas_and_ref(B, S, H, KV, D, window, cap,
                                             dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(B, H, D), (B, KV, S, D), (B, KV, S, D)], dtype)
    # ragged positions: the first and last slot, a tile edge, the rest random
    rng = np.random.default_rng(7)
    pos = np.concatenate([[0, S - 1, 63],
                          rng.integers(1, S, max(B - 3, 0))])[:B].astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    before = dec_k.decode_attention.launches
    got = dec_k.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                 scale=scale, window=window, cap=cap)
    assert dec_k.decode_attention.launches == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_decode(jq, jk, jv, jnp.asarray(pos), scale=scale,
                        window=window, cap=cap, kv_block=64, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos),
                                       scale=scale, window=window, cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


def test_ops_wrappers_model_layout():
    """The model-layout wrappers transpose views only: same numbers as the
    kernel-layout plain versions, no kernel launch on CPU tensors."""
    B, S, H, KV, D = 2, 40, 4, 2, 64
    _, (q, k, v) = _inputs(3, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)],
                           "float32")
    scale = 1.0 / np.sqrt(D)
    launches = (fa_k.flash_attention.launches, dec_k.decode_attention.launches)
    out = ops.flash_attention(q, k, v, scale=scale)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), scale=scale)
    torch.testing.assert_close(out, want.transpose(1, 2))
    pos = torch.tensor([5, S - 1], dtype=torch.int32)
    dec = ops.decode_attention(q[:, :1], k, v, pos, scale=scale)
    want = ref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                    v.transpose(1, 2), pos, scale=scale)
    torch.testing.assert_close(dec[:, 0], want)
    assert (fa_k.flash_attention.launches,
            dec_k.decode_attention.launches) == launches


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 4, 8, 64), device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fa_k.flash_attention(q, q[:, :2], q[:, :2], scale=0.125)
    with pytest.raises(ValueError):
        dec_k.decode_attention(q[:, :, 0], q[:, :2], q[:, :2], pos,
                               scale=0.125)
    pool = torch.zeros((3, 2, 4, 64), device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dec_k.paged_decode_attention(q[:, :, 0], pool, pool, table, pos,
                                     scale=0.125)
    x = torch.zeros((1, 2, 32, 32), device="meta")
    bc = torch.zeros((1, 32, 16), device="meta")
    with pytest.raises(ValueError):
        ssd_k.ssd_scan(x, x[..., 0], torch.zeros(2, device="meta"), bc, bc,
                       chunk=16)


def _shuffled_pools(rng, k, v, bs, extra=3):
    """Scatter linear (B,KV,S,D) caches into shuffled block pools
    (N,KV,bs,D) with a non-contiguous, non-monotonic table (B, S // bs);
    the unused blocks hold other values, which a gather must skip (the
    numpy form of tests/test_kernels.py::_paged_from_linear)."""
    B, KV, S, D = k.shape
    nb = S // bs
    n_pool = B * nb + extra
    table = rng.permutation(n_pool)[:B * nb].astype(np.int32).reshape(B, nb)
    k_pool = rng.standard_normal((n_pool, KV, bs, D)).astype(np.float32)
    v_pool = k_pool[::-1].copy()
    for b in range(B):
        for i in range(nb):
            k_pool[table[b, i]] = k[b, :, i * bs:(i + 1) * bs]
            v_pool[table[b, i]] = v[b, :, i * bs:(i + 1) * bs]
    return k_pool, v_pool, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,KV,D,bs,window,cap",
    [
        (4, 128, 4, 2, 64, 32, 0, 0.0),    # GQA, ragged edges
        (3, 128, 8, 2, 64, 16, 40, 0.0),   # window across block seams
        (2, 96, 4, 4, 128, 8, 0, 30.0),    # small blocks, D=128, tanh cap
    ],
)
def test_paged_plain_matches_pallas(B, S, H, KV, D, bs, window, cap, dtype):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    k_pool, v_pool, table = _shuffled_pools(rng, k, v, bs)
    # ragged positions: a block's first and last slot, the last slot, one
    # random
    pos = np.array([bs, bs - 1, S - 1, rng.integers(1, S)],
                   np.int32)[:B]
    jx, tx = [], []
    for a in (q, k_pool, v_pool):
        jx.append(jnp.asarray(a, getattr(jnp, dtype)))
        tx.append(torch.from_numpy(a).to(getattr(torch, dtype)))
    scale = 1.0 / np.sqrt(D)
    before = dec_k.paged_decode_attention.launches
    got = dec_k.paged_decode_attention(*tx, torch.from_numpy(table),
                                       torch.from_numpy(pos), scale=scale,
                                       window=window, cap=cap)
    assert dec_k.paged_decode_attention.launches == before
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    pallas = jax_paged_decode(*jx, jnp.asarray(table), jnp.asarray(pos),
                              scale=scale, window=window, cap=cap,
                              interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    # the same numbers as the linear plain version on the gathered cache
    lin = ref.decode_attention_ref(
        tx[0], ops.gather_kv_blocks(tx[1].transpose(1, 2),
                                    torch.from_numpy(table)).transpose(1, 2),
        ops.gather_kv_blocks(tx[2].transpose(1, 2),
                             torch.from_numpy(table)).transpose(1, 2),
        torch.from_numpy(pos), scale=scale, window=window, cap=cap)
    assert torch.equal(got, lin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,L,P,N,chunk",
    [
        (2, 4, 128, 64, 32, 32),
        (1, 8, 256, 32, 64, 64),
        (2, 3, 64, 64, 128, 16),  # odd head count, many chunks
        (1, 2, 48, 32, 16, 256),  # one chunk, Q = L < chunk
        (1, 3, 96, 64, 32, 12),   # Q = 12: less than one 16-row tile
        (2, 2, 120, 32, 128, 20),  # Q = 20: a ragged second tile
        (2, 5, 448, 32, 16, 16),  # H = 5 in head groups of 3 and 2
    ],
)
def test_ssd_plain_matches_pallas(B, H, L, P, N, chunk, dtype):
    """tests/test_kernels.py::test_ssd_scan_matches_oracle's grid and
    tolerances, and the edge shapes of the CUDA kernels, against the Pallas
    kernel itself: the one-pass plain version and the three-pass plain
    decomposition the CUDA kernels run (chunk states, the fp32 recurrence,
    the output from the starting states), which also matches the one-pass
    version to fp32 rounding."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, H, L, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, L)))).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    b = rng.standard_normal((B, L, N)).astype(np.float32)
    c = rng.standard_normal((B, L, N)).astype(np.float32)
    jx, tx = [], []
    for arr, cast in ((x, True), (dt, True), (a_neg, False), (b, True),
                      (c, True)):
        jx.append(jnp.asarray(arr, getattr(jnp, dtype) if cast else jnp.float32))
        tx.append(torch.from_numpy(arr).to(getattr(torch, dtype) if cast
                                           else torch.float32))
    before = ssd_k.ssd_scan.launches
    y, h = ssd_k.ssd_scan(*tx, chunk=chunk)
    passes = ssd_k.ssd_scan_passes(*tx, chunk=chunk)
    assert ssd_k.ssd_scan.launches == before
    assert y.dtype == tx[0].dtype and h.dtype == torch.float32
    assert passes["y"].dtype == y.dtype and passes["h"].dtype == torch.float32
    jy, jh = jax_ssd_scan(*jx, chunk=chunk, interpret=True)
    # bf16: the same inputs, fp32 inside both; y rounded to bf16
    tol = dict(rtol=5e-2, atol=1e-1) if dtype == "bfloat16" else \
        dict(rtol=1e-3, atol=1e-3)
    for got_y, got_h in ((y, h), (passes["y"], passes["h"])):
        np.testing.assert_allclose(_f32(got_y), _f32(jy), **tol)
        np.testing.assert_allclose(_f32(got_h), _f32(jh), **tol)
    torch.testing.assert_close(passes["h"], h, rtol=1e-4, atol=1e-4)
    nc = L // min(chunk, L)
    assert passes["chunk_states"].shape == (B, nc, H, N, P)
    assert passes["starts"].shape == (B, nc, H, N, P)
    assert passes["chunk_decay"].shape == (B, nc, H)
    assert not passes["starts"][:, 0].any()  # the scan starts from h = 0


def test_ssd_plain_passes_on_model_layout_views():
    """B = 2 on the views ssm_forward passes: x and dt transposed from
    (B,L,H,·), b and c column slices of one (B,L,DI + 2N) tensor (row
    stride DI + 2N).  The decomposition's intermediates against the one-pass
    version chunk by chunk: the starting state of chunk k is the final state
    of the scan over the first k chunks, in fp32."""
    B, L, H, P, N, chunk = 2, 96, 3, 32, 16, 32
    rng = np.random.default_rng(9)
    xbc = torch.from_numpy(
        rng.standard_normal((B, L, H * P + 2 * N)).astype(np.float32))
    x = xbc[..., :H * P].reshape(B, L, H, P).transpose(1, 2)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, L, H))))
                          .astype(np.float32)).transpose(1, 2)
    a = -torch.exp(torch.from_numpy(rng.standard_normal(H).astype(np.float32)))
    assert b.stride(1) == H * P + 2 * N and x.stride(2) == H * P + 2 * N
    got = ssd_k.ssd_scan_passes(x, dt, a, b, c, chunk=chunk)
    wy, wh = ref.ssd_scan_ref(x, dt, a, b, c, chunk=chunk)
    torch.testing.assert_close(got["y"], wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["h"], wh, rtol=1e-4, atol=1e-4)
    for k in range(1, L // chunk):
        _, hk = ref.ssd_scan_ref(x[:, :, :k * chunk], dt[:, :, :k * chunk], a,
                                 b[:, :k * chunk], c[:, :k * chunk],
                                 chunk=chunk)
        torch.testing.assert_close(got["starts"][:, k], hk, rtol=1e-4,
                                   atol=1e-4)
    cl = torch.cumsum((dt * a[:, None]).reshape(B, H, -1, chunk), dim=-1)
    torch.testing.assert_close(got["chunk_decay"], cl[..., -1].transpose(1, 2))


@pytest.mark.parametrize("B,H,L,chunk,kernels,shape", [
    (1, 48, 2048, 256, 3, (3, 6, 2)),  # mamba2-780m: 128 blocks a pass
    (1, 2, 128, 32, 3, (1, 1, 1)),     # the tuning shapes
    (1, 2, 128, 128, 2, (1, 1, 2)),    # one chunk: no recurrence
    (1, 2, 48, 256, 2, (1, 1, 2)),     # Q = L < chunk
    (2, 5, 448, 16, 3, (3, 3, 1)),     # H = 5: head groups of 3 and 2
    (4, 48, 8192, 256, 3, (8, 8, 2)),  # many chunks: the group cap
])
def test_ssd_launch_geometry(B, H, L, chunk, kernels, shape):
    """Kernels per call, heads per block and row blocks: each pass fills
    the H100's 132 SMs at most once where it can, and a block holds at
    most MAX_GROUP heads."""
    assert ssd_k.ssd_kernels(B, H, L, chunk) == kernels
    G1, G3, R = ssd_k.launch_shape(B, H, L, chunk)
    assert (G1, G3, R) == shape
    nc = L // ssd_k.kernel_chunk(min(chunk, L))
    for G, blocks in ((G1, B * nc), (G3, B * nc * R)):
        assert 1 <= G <= ssd_k.MAX_GROUP
        assert blocks * -(-H // G) <= 132 or G == ssd_k.MAX_GROUP


@pytest.mark.parametrize("Q,want", [(4, 4), (12, 12), (256, 256), (260, 52),
                                    (512, 256), (1024, 256), (1000, 200)])
def test_ssd_kernel_chunk_divides_the_chunk(Q, want):
    """A chunk above 256 rows runs as its largest divisor of at most 256
    rows that is a multiple of 4; the scan's function does not depend on
    the chunk (ssd_scan_ref agrees across chunks to fp32 rounding)."""
    assert ssd_k.kernel_chunk(Q) == want
    assert Q % want == 0 and want % 4 == 0 and want <= ssd_k.MAX_CHUNK


def test_ssd_plain_does_not_depend_on_the_chunk():
    rng = np.random.default_rng(3)
    B, H, L, P, N = 1, 2, 512, 32, 16
    x = torch.from_numpy(rng.standard_normal((B, H, L, P)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, H, L))))
                          .astype(np.float32))
    a = -torch.ones(H)
    b = torch.from_numpy(rng.standard_normal((B, L, N)).astype(np.float32))
    y1, h1 = ref.ssd_scan_ref(x, dt, a, b, b.flip(1), chunk=512)
    y2, h2 = ref.ssd_scan_ref(x, dt, a, b, b.flip(1), chunk=256)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)


def test_paged_and_ssd_ops_wrappers_model_layout():
    """Model layout in, the kernel-layout plain versions' numbers out."""
    rng = np.random.default_rng(4)
    B, S, H, KV, D, bs = 2, 64, 4, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    kp, vp, table = _shuffled_pools(rng, k, k[:, :, ::-1].copy(), bs)
    kp, vp, tbl = map(torch.from_numpy, (kp, vp, table))
    pos = torch.tensor([S - 1, bs + 3], dtype=torch.int32)
    launches = dec_k.paged_decode_attention.launches
    out = ops.paged_decode_attention(q, kp.transpose(1, 2), vp.transpose(1, 2),
                                     tbl, pos, scale=0.125)
    want = ref.paged_decode_attention_ref(q[:, 0], kp, vp, tbl, pos,
                                          scale=0.125)
    torch.testing.assert_close(out[:, 0], want)
    assert dec_k.paged_decode_attention.launches == launches
    lin = ops.gather_kv_blocks(kp.transpose(1, 2), tbl)
    assert lin.shape == (B, S, KV, D)
    torch.testing.assert_close(lin.transpose(1, 2), torch.from_numpy(k))

    L, Hs, P, N = 64, 3, 32, 16
    x = torch.from_numpy(rng.standard_normal((1, L, Hs, P)).astype(np.float32))
    dt = torch.rand(1, L, Hs, generator=torch.Generator().manual_seed(0))
    a = -torch.ones(Hs)
    b = torch.from_numpy(rng.standard_normal((1, L, N)).astype(np.float32))
    y, h = ops.ssd_scan(x, dt, a, b, b.flip(1), chunk=16)
    wy, wh = ref.ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), a, b,
                              b.flip(1), chunk=16)
    torch.testing.assert_close(y, wy.transpose(1, 2))
    torch.testing.assert_close(h, wh)


@pytest.mark.parametrize("B,KV", [(1, 1), (1, 2), (4, 8), (8, 8), (64, 8),
                                  (3, 4)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 200, 512, 1000, 4096,
                               32768])
def test_decode_splits_cover_every_tile_once(B, KV, S):
    """The split-K kernel's split of the kv walk: every 64-key tile of the
    cache in exactly one split, no split without a tile, one split for a
    single tile, and no more blocks than needed to reach the target."""
    splits, per = dec_k.decode_splits(B, KV, S)
    tiles = -(-S // 64)
    covered = [t for s in range(splits)
               for t in range(s * per, min((s + 1) * per, tiles))]
    assert covered == list(range(tiles))
    assert all(s * per < tiles for s in range(splits))  # no empty split
    assert 1 <= splits <= tiles
    if tiles == 1:
        assert (splits, per) == (1, 1)
    if splits > 1:  # splits are only added while short of the target
        assert B * KV * (splits - 1) < dec_k.TARGET_BLOCKS


def test_decode_splits_fill_the_card():
    """At B = 4, KV = 8, S = 4096 (the long-cache case of chip_smoke.py)
    the split reaches about four blocks per SM of the H100's 132, with
    8-16 splits; a cache of <= 64 positions is one split."""
    splits, per = dec_k.decode_splits(4, 8, 4096)
    assert 8 <= splits <= 16 and splits * per >= 64
    assert 4 * 8 * splits >= 0.95 * dec_k.TARGET_BLOCKS
    for S in (1, 17, 64):
        assert dec_k.decode_splits(4, 8, S) == (1, 1)


@pytest.mark.parametrize(
    "B,S,H,KV,D,window,cap,splits",
    [
        (4, 300, 8, 2, 64, 0, 0.0, None),    # decode_splits' choice
        (4, 1000, 8, 8, 64, 0, 0.0, 16),     # empty splits for short rows
        (3, 700, 4, 2, 128, 200, 0.0, 4),    # window starts inside a split
        (2, 520, 8, 2, 64, 70, 30.0, 9),     # window + cap, last split short
        (3, 64, 4, 4, 64, 0, 0.0, 1),        # one split: no combine
    ],
)
def test_decode_split_ref_matches_pallas_and_ref(B, S, H, KV, D, window, cap,
                                                 splits):
    """The plain split-and-combine (the split-K kernel's arithmetic) against
    the one-pass plain version and the Pallas decode kernel (interpret
    mode), in fp32.  Tolerance 2e-4: the same fp32 scores, summed per split
    and rescaled by e^(m_s - M) before the combine, so only the order of
    the sums differs (tests/test_kernels.py's fp32 tolerance)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        5, [(B, H, D), (B, KV, S, D), (B, KV, S, D)], "float32")
    if splits is None:
        splits, per = dec_k.decode_splits(B, KV, S)
    else:
        per = -(-(-(-S // 64)) // splits)
        splits = -(-(-(-S // 64)) // per)
    # positions: the first slot, a tile edge, the last slot, a split edge
    pos = np.array([0, 64, S - 1, per * 64 - 1][:B], np.int32)
    pos = np.minimum(pos, S - 1)
    scale = 1.0 / np.sqrt(D)
    got = ref.decode_attention_split_ref(
        tq, tk, tv, torch.from_numpy(pos), scale=scale, splits=splits,
        tiles=per, window=window, cap=cap)
    want = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos),
                                    scale=scale, window=window, cap=cap)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    pallas = jax_decode(jq, jk, jv, jnp.asarray(pos), scale=scale,
                        window=window, cap=cap, kv_block=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=2e-4, atol=2e-4)
