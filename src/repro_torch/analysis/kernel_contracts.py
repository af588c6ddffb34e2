"""Hopper kernel contracts (KC2xx): the launches of the port's CUDA kernels
(B1-B4 and the fp32 training attention), mirrored in pure math and audited
against the H100's limits;
the port's twin of ``repro.analysis.kernel_contracts`` (KC1xx, the TPU's
BlockSpec/VMEM rules, which say nothing about a Hopper kernel).

Each kernel commits to a *contract*: the sizes it was instantiated for,
and per launch the grid, the threads, the dynamic shared memory the launch
sets, ``__launch_bounds__``'s minimum blocks and the blocks per SM its
design claims.  The mirror here copies the constants and formulas of the
``.cu`` sources and takes the host sizing the wrappers use
(``decode_attention.decode_splits``, ``ssd_scan.kernel_chunk`` and
``ssd_scan.launch_shape``).  The rules:

- **KC200**: a ``TUNABLE_OPS`` entry (``kernels/ops.py``) that no contract
  covers.
- **KC201**: a route to a kernel at sizes it has no instantiation for, or
  that break its entry's checks: D not in {64, 128} (B1-B3 and the
  training attention),
  ``H / KV > 16`` (B2, B3), P not in {32, 64}, N not in {16, 32, 64,
  128}, a chunk above 256 rows or not a multiple of 4, ``L % Q``, G1 not
  in [1, 8], R not in [1, 2], more than 4 strip pairs a row block (B4).
- **KC202**: a block's shared memory over the 232,448 B a block can opt
  into, or the blocks per SM the design claims, each with 1 KB the
  runtime reserves, over the SM's 233,472 B; and B2's merge of its warps'
  states, which reuses the K/V ring, larger than the ring.
- **KC203**: the blocks per SM the design claims do not fit the register
  file at the cap ``__launch_bounds__`` gives the compiler,
  65,536 / (threads x minimum blocks), or break the SM's thread and block
  limits.
- **KC204**: a grid over the limits (x <= 2^31 - 1, y and z <= 65,535,
  none 0) or a block over 1024 threads, for every launch: B2's combine
  pass and B4's three passes too.
- **KC205**: ``H % KV != 0`` (the kernels map query head h to kv head
  ``h / (H / KV)``).
- **KC206**: the fp32 scratch the wrappers allocate over the card's 80 GB:
  B2's ``splits * B * H * (D + 2)``, B4's states ``B * nc * H * N * P``
  and its cumsums ``B * L * H``, the training attention's LSE and Delta
  ``2 * B * H * S``.
- **KC207**: a 1F1B stage's working set over Eq. 5's HBM budget on the
  H100 (the twin of JAX's KC107, on ``core.memory_model``).
- **KC208**: mirror drift: the constants and instantiation sets the mirror
  copies (``BQ``, ``BK``, ``NTHREADS``, ``NWARPS``, ``stages<D>``,
  ``kpitch``, ``QMAX``, ``MAX_GROUP``, the launch bounds, the D/P/N
  dispatch, the entries' limits), read back from the ``.cu``/``.cuh``
  text, and the wrappers' own copies (``HEAD_DIMS``, ``TILE``,
  ``P_SIZES``...); for the training attention ``BM``, ``BN``, ``TY``,
  ``TP``, its launch bounds and its D dispatch.  The text is the source
  of truth.

The registry sweep routes every arch in ``configs.ARCH_IDS`` as the port
serves it (``api.session.serve_attn_impl``, ``models.attention.
decode_impl``, ``models.blocks._ssm_impl``), in bf16 and fp32 on a card,
at full width and the JAX sweep's batch of 1: B1 at ``prefill_32k``, B2
at ``decode_32k`` and ``long_500k``, B3 at ``decode_32k`` over pools of
``JobSpec.kv_block``, B4 at ``prefill_32k`` for the config's chunk and
each chunk of ``ops.tune_candidates("ssd_scan")``.  A route to
``"dense"`` (MLA, fp32 on a card, a wrapped sliding-window ring) is
recorded with no contract.  Training routes every arch's attention in
bf16 and fp32 at ``train_4k`` as ``attention(impl="auto")`` does on a
card (``kernels.flash_attention_train.takes``): the three training
kernels, else ``"chunked"`` (a cap, MLA's head dims, bf16).

:func:`card_check` is the card's side: each ``.cu`` exports an
``extern "C"`` query (it launches nothing) that reports, per
instantiation, what the runtime says of the compiled kernel
(``cudaFuncGetAttributes``, the dynamic shared memory the launch sets,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at that size), and the
mirror is held to it.
"""
from __future__ import annotations

import ast
import ctypes
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core.hardware import CLUSTERS, H100_SXM, Chip
from repro_torch.kernels import _launch
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention_train as fat_k
from repro_torch.kernels import ssd_scan as ssd_k

# ---------------------------------------------------------------------------
# The H100's limits (CUDA C++ Programming Guide, compute capability 9.0)
# ---------------------------------------------------------------------------

SMEM_OPTIN = 232_448     # shared memory one block can opt into
SMEM_PER_SM = 233_472    # shared memory of one SM
SMEM_RESERVED = 1_024    # reserved by the runtime for each resident block
REGS_PER_SM = 65_536
MAX_REGS_PER_THREAD = 255
REG_ALLOC = 8            # registers are allocated 256 a warp, 8 a thread
MAX_THREADS_PER_BLOCK = 1_024
MAX_THREADS_PER_SM = 2_048
MAX_BLOCKS_PER_SM = 32
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
HBM_BYTES = H100_SXM.hbm_bytes

# ---------------------------------------------------------------------------
# The mirror: what the .cu sources say (KC208 reads them back)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# flash_attention.cu
FLASH = {"BQ": 128, "BK": 64, "NTHREADS": 256}
FLASH_D = (64, 128)
FLASH_MIN_BLOCKS = {64: 2, 128: 1}  # __launch_bounds__(NTHREADS, D == 64 ? 2 : 1)
FLASH_CLAIM = {64: 2, 128: 1}       # "two blocks share an SM" at D = 64
# attention_tile.cuh and decode_attention.cu
TILE = {"BK": 64, "NWARPS": 4, "NTHREADS": 128}
DECODE_D = (64, 128)
DECODE_STAGES = {64: 4, 128: 3}
KPITCH_PAD = 8                      # kpitch<D>() = D + 8
MAX_G = 16                          # 16 query rows a warp
DECODE_CLAIM = {64: 2, 128: 2}      # "three stages at D = 128 keep two blocks"
# ssd_scan.cu
SSD = {"NWARPS": 8, "NTHREADS": 256, "QMAX": 256, "MAX_GROUP": 8}
SSD_P = (32, 64)
SSD_N = (16, 32, 64, 128)
SSD_MAX_R = 2
SSD_PAIR_DIV = 2                    # pairs_max <= NWARPS / 2
STATE_THREADS = 256

# flash_attention_train.cu
FLASH_TRAIN = {"BM": 64, "BN": 64, "TY": 16, "TP": 68}
FLASH_TRAIN_D = (64, 128)
FLASH_TRAIN_MIN_BLOCKS = {64: 2, 128: 1}  # __launch_bounds__(2 * D, D == 64 ? 2 : 1)
FLASH_TRAIN_CLAIM = {64: 2, 128: 1}       # two blocks an SM at D = 64
FLASH_TRAIN_KINDS = ("fwd", "dq", "dkdv")  # flash_train_query's kind 0, 1, 2

KERNEL_FILES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_train": "src/repro_torch/csrc/flash_attention_train.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "pipeline_stage": "src/repro_torch/distributed/pipeline.py",
}
DTYPE_NAMES = {"bfloat16": "bf16", "float32": "fp32"}


def flash_smem(D: int) -> int:
    """Q, two stages of K and V, 1024 for alignment (``smem_bytes<D>``)."""
    return (FLASH["BQ"] * D + 4 * FLASH["BK"] * D) * 2 + 1024


def flash_train_smem(kind: str, D: int) -> int:
    """``fwd_bytes<D>``, ``dq_bytes<D>``, ``dkdv_bytes<D>``: fp32 tiles,
    transposed ones of pitch TP, streamed ones of pitch D + 4."""
    BM, BN, TP = FLASH_TRAIN["BM"], FLASH_TRAIN["BN"], FLASH_TRAIN["TP"]
    rp = D + 4
    floats = {
        "fwd": D * TP + BN * TP + 2 * (2 * BN * rp + BN),  # Q^T, P^T, 2 stages
        "dq": 2 * D * TP + BN * TP + 2 * BN * rp + BN + BM,
        "dkdv": 2 * D * TP + 2 * BN * TP + 2 * BN * rp + 3 * BN,
    }[kind]
    return 4 * floats


def flash_train_launch(kind: str, D: int, grid=(0, 0, 0)) -> "Launch":
    return Launch(f"{kind}_kernel<{D}>", grid, 2 * D, flash_train_smem(kind, D),
                  min_blocks=FLASH_TRAIN_MIN_BLOCKS[D],
                  claimed_blocks=FLASH_TRAIN_CLAIM[D])


def decode_smem(D: int) -> int:
    """The K/V ring in bf16, K and V of pitch ``kpitch<D>``."""
    return DECODE_STAGES[D] * TILE["BK"] * (D + KPITCH_PAD) * 2 * 2


def decode_merge_bytes(D: int) -> int:
    """The warps' states merged through the (free) ring: 16 rows a warp of
    D sums, m and l, in fp32."""
    return TILE["NWARPS"] * 16 * (D + 2) * 4


def combine_static(D: int) -> int:
    return 2 * (D // 32) * 4  # red[2][D / 32] floats


def padded(Q: int) -> int:
    return (Q + 15) & ~15


def chunk_smem(Qp: int, P: int, N: int) -> int:
    """Pass 1: B, the two-slot x ring, s of the block's heads."""
    return Qp * N * 2 + 2 * Qp * P * 2 + SSD["MAX_GROUP"] * Qp * 4


def pairs_max(Qp: int, R: int) -> int:
    return ((Qp // 16 + 1) // 2 + R - 1) // R


def output_smem(Qp: int, P: int, N: int, R: int) -> int:
    """Pass 3: C Bᵀ tiles, C of the strips, the x/B region, cl and dt, and
    the partial sums handed between warps."""
    pm = pairs_max(Qp, R)
    region = max(Qp * P + Qp * N, 2 * Qp * P + 2 * N * P)
    return (pm * (Qp // 16 + 1) * 1024 + 2 * pm * 16 * N * 2 + region * 2
            + 2 * Qp * 4 + pm * 16 * P * 4)


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a contract."""
    kernel: str                 # the instantiation, e.g. "flash_kernel<64>"
    grid: Tuple[int, int, int]
    threads: int
    dyn_smem: int               # bytes the launch sets
    static_smem: int = 0        # the kernel's own __shared__ arrays
    min_blocks: int = 1         # __launch_bounds__'s second argument
    claimed_blocks: int = 1     # blocks per SM the design claims


@dataclasses.dataclass(frozen=True)
class HopperContract:
    op: str
    context: str                # "op:arch:shape:dtype:slot" fingerprint
    sizes: Tuple[Tuple[str, int], ...]
    launches: Tuple[Launch, ...]
    scratch_bytes: int = 0      # fp32 scratch the wrapper allocates


def _finding(op: str, code: str, msg: str, context: str) -> Finding:
    return Finding(path=KERNEL_FILES[op], line=0, code=code, message=msg,
                   context=context)


def _gqa_faults(op: str, H: int, KV: int, context: str) -> List[Finding]:
    if KV <= 0 or H % KV:
        return [_finding(op, "KC205",
                         f"H={H} not divisible by KV={KV}; the kernels map "
                         "query head h to kv head h / (H / KV)", context)]
    return []


def flash_contract(*, B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
                   context: str = "flash_attention",
                   ) -> Tuple[Optional[HopperContract], List[Finding]]:
    """B1: one block of two warpgroups per (128 q rows, head, batch)."""
    op = "flash_attention"
    bad = _gqa_faults(op, H, KV, context)
    if D not in FLASH_D:
        bad.append(_finding(op, "KC201", f"head dim D={D} has no "
                            f"instantiation (D in {FLASH_D})", context))
    if bad:
        return None, bad
    launch = Launch(f"flash_kernel<{D}>", (-(-Sq // FLASH["BQ"]), H, B),
                    FLASH["NTHREADS"], flash_smem(D),
                    min_blocks=FLASH_MIN_BLOCKS[D],
                    claimed_blocks=FLASH_CLAIM[D])
    sizes = (("B", B), ("H", H), ("KV", KV), ("Sq", Sq), ("Sk", Sk), ("D", D))
    return HopperContract(op, context, sizes, (launch,)), []


def flash_train_contract(*, B: int, H: int, KV: int, S: int, D: int,
                         context: str = "flash_attention_train",
                         ) -> Tuple[Optional[HopperContract], List[Finding]]:
    """The training attention: the forward and dQ, one block of 2 D
    threads per (head, 64 queries, batch), and dK/dV, one per (kv head,
    64 keys, batch); LSE and Delta as scratch."""
    op = "flash_attention_train"
    bad = _gqa_faults(op, H, KV, context)
    if D not in FLASH_TRAIN_D:
        bad.append(_finding(op, "KC201", f"head dim D={D} has no "
                            f"instantiation (D in {FLASH_TRAIN_D})", context))
    if bad:
        return None, bad
    n = -(-S // FLASH_TRAIN["BM"])
    launches = tuple(flash_train_launch(kind, D, (heads, n, B))
                     for kind, heads in (("fwd", H), ("dq", H), ("dkdv", KV)))
    sizes = (("B", B), ("H", H), ("KV", KV), ("S", S), ("D", D))
    return HopperContract(op, context, sizes, launches, 2 * B * H * S * 4), []


def decode_contract(*, B: int, H: int, KV: int, S: int, D: int,
                    paged: bool = False, context: str = "decode_attention",
                    ) -> Tuple[Optional[HopperContract], List[Finding]]:
    """B2 (B3 with ``paged``): grid (KV, B, splits) from ``decode_splits``,
    and the combine pass, one block of D threads per (row, head), when
    there is more than one split."""
    op = "paged_decode_attention" if paged else "decode_attention"
    bad = _gqa_faults(op, H, KV, context)
    if D not in DECODE_D:
        bad.append(_finding(op, "KC201", f"head dim D={D} has no "
                            f"instantiation (D in {DECODE_D})", context))
    if not bad and H // KV > MAX_G:
        bad.append(_finding(op, "KC201",
                            f"H / KV = {H // KV} query heads per kv head; "
                            f"the kernel holds at most {MAX_G}", context))
    if bad:
        return None, bad
    splits, _ = dec_k.decode_splits(B, KV, S)
    launches = [Launch(f"decode_kernel<{D}, {str(paged).lower()}>",
                       (KV, B, splits), TILE["NTHREADS"], decode_smem(D),
                       claimed_blocks=DECODE_CLAIM[D])]
    scratch = 0
    if splits > 1:
        launches.append(Launch(f"decode_combine_kernel<{D}>", (B * H, 1, 1),
                               D, splits * 4, static_smem=combine_static(D)))
        scratch = splits * B * H * (D + 2) * 4
    sizes = (("B", B), ("H", H), ("KV", KV), ("S", S), ("D", D),
             ("splits", splits))
    return HopperContract(op, context, sizes, tuple(launches), scratch), []


def paged_decode_contract(*, B: int, H: int, KV: int, bs: int, nb: int,
                          D: int, context: str = "paged_decode_attention",
                          ) -> Tuple[Optional[HopperContract], List[Finding]]:
    """B3: B2's template with ``PAGED = true``, split over the logical
    length nb * bs."""
    return decode_contract(B=B, H=H, KV=KV, S=nb * bs, D=D, paged=True,
                           context=context)


def ssd_contract(*, B: int, H: int, L: int, P: int, N: int, chunk: int,
                 context: str = "ssd_scan",
                 ) -> Tuple[Optional[HopperContract], List[Finding]]:
    """B4: the chunk pass, the state pass (more than one chunk only) and
    the output pass, at the kernel chunk and launch shape the wrapper
    picks."""
    op = "ssd_scan"
    Q = min(chunk, L)
    bad = []
    if P not in SSD_P:
        bad.append(f"P={P} has no instantiation (P in {SSD_P})")
    if N not in SSD_N:
        bad.append(f"N={N} has no instantiation (N in {SSD_N})")
    if Q <= 0 or Q % 4:
        bad.append(f"chunk {Q} is not a positive multiple of 4")
    elif L % Q:
        bad.append(f"L={L} is not a multiple of the chunk {Q}")
    if bad:
        return None, [_finding(op, "KC201", "; ".join(bad), context)]
    Qk = ssd_k.kernel_chunk(Q)
    nc = L // Qk
    G1, G3, R = ssd_k.launch_shape(B, H, L, Qk)
    Qp = padded(Qk)
    if (Qk > SSD["QMAX"] or L % Qk or G1 < 1 or G1 > SSD["MAX_GROUP"]
            or G3 < 1 or not 1 <= R <= SSD_MAX_R
            or pairs_max(Qp, R) > SSD["NWARPS"] // SSD_PAIR_DIV):
        return None, [_finding(
            op, "KC201", f"kernel chunk {Qk}, G1={G1}, G3={G3}, R={R} "
            f"({pairs_max(Qp, R)} strip pairs a row block) break "
            "ssd_scan_bf16's checks", context)]
    launches = [Launch(f"chunk_pass<{P}, {N}>", (B * nc, -(-H // G1), 1),
                       SSD["NTHREADS"], chunk_smem(Qp, P, N))]
    if nc > 1:
        threads = B * H * N * P // 4
        launches.append(Launch("state_pass",
                               (-(-threads // STATE_THREADS), 1, 1),
                               STATE_THREADS, 0))
    launches.append(Launch(f"output_pass<{P}, {N}>",
                           (B * nc * R, -(-H // G3), 1), SSD["NTHREADS"],
                           output_smem(Qp, P, N, R)))
    scratch = (B * nc * H * N * P + B * L * H) * 4
    sizes = (("B", B), ("H", H), ("L", L), ("P", P), ("N", N), ("Q", Qk),
             ("G1", G1), ("G3", G3), ("R", R))
    return HopperContract(op, context, sizes, tuple(launches), scratch), []


# ---------------------------------------------------------------------------
# Contract checks
# ---------------------------------------------------------------------------


def reg_cap(threads: int, min_blocks: int) -> int:
    """Registers a thread may use under ``__launch_bounds__(threads,
    min_blocks)``."""
    warps = -(-threads // 32)
    per_thread = REGS_PER_SM // (max(min_blocks, 1) * warps * 32)
    return min(MAX_REGS_PER_THREAD, per_thread // REG_ALLOC * REG_ALLOC)


def check_contract(c: HopperContract) -> List[Finding]:
    out: List[Finding] = []
    for ln in c.launches:
        smem = ln.dyn_smem + ln.static_smem
        if smem > SMEM_OPTIN:
            out.append(_finding(
                c.op, "KC202",
                f"{ln.kernel}: {smem} B of shared memory a block, over the "
                f"{SMEM_OPTIN} B a block can opt into", c.context))
        elif ln.claimed_blocks * (smem + SMEM_RESERVED) > SMEM_PER_SM:
            out.append(_finding(
                c.op, "KC202",
                f"{ln.kernel}: {ln.claimed_blocks} blocks of {smem} B (+"
                f"{SMEM_RESERVED} B reserved each) claimed on an SM of "
                f"{SMEM_PER_SM} B", c.context))
        cap = reg_cap(ln.threads, ln.min_blocks)
        alloc = -(-cap // REG_ALLOC) * REG_ALLOC
        if ln.claimed_blocks * ln.threads * alloc > REGS_PER_SM:
            out.append(_finding(
                c.op, "KC203",
                f"{ln.kernel}: {ln.claimed_blocks} blocks of {ln.threads} "
                f"threads claimed, but __launch_bounds__(_, "
                f"{ln.min_blocks}) lets a thread take {cap} registers: "
                f"{ln.claimed_blocks * ln.threads * alloc} of "
                f"{REGS_PER_SM}", c.context))
        if (ln.claimed_blocks * ln.threads > MAX_THREADS_PER_SM
                or ln.claimed_blocks > MAX_BLOCKS_PER_SM):
            out.append(_finding(
                c.op, "KC203",
                f"{ln.kernel}: {ln.claimed_blocks} blocks of {ln.threads} "
                "threads claimed on one SM, over its "
                f"{MAX_THREADS_PER_SM} threads or {MAX_BLOCKS_PER_SM} "
                "blocks", c.context))
        gx, gy, gz = ln.grid
        if (min(ln.grid) < 1 or gx > GRID_X_MAX or gy > GRID_YZ_MAX
                or gz > GRID_YZ_MAX or ln.threads > MAX_THREADS_PER_BLOCK):
            out.append(_finding(
                c.op, "KC204",
                f"{ln.kernel}: grid {ln.grid} x {ln.threads} threads "
                f"breaks the limits (x <= {GRID_X_MAX}, y, z <= "
                f"{GRID_YZ_MAX}, none 0; <= {MAX_THREADS_PER_BLOCK} "
                "threads)", c.context))
        if ln.kernel.startswith("decode_kernel"):
            D = dict(c.sizes)["D"]
            if decode_merge_bytes(D) > ln.dyn_smem:
                out.append(_finding(
                    c.op, "KC202",
                    f"{ln.kernel}: the warps' merge needs "
                    f"{decode_merge_bytes(D)} B, the ring holds "
                    f"{ln.dyn_smem} B", c.context))
    if c.scratch_bytes > HBM_BYTES:
        out.append(_finding(
            c.op, "KC206",
            f"{c.scratch_bytes:.4g} B of fp32 scratch, over the card's "
            f"{HBM_BYTES:.4g} B", c.context))
    return out


# ---------------------------------------------------------------------------
# Registry sweep: every arch as the port routes it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Route:
    """Where one (op, arch, shape, dtype, slot) goes on the card."""
    op: str
    context: str
    impl: str  # "kernel", else "dense" or (training) "chunked"


def _tune_chunks() -> Tuple[int, ...]:
    from repro_torch.kernels.ops import tune_candidates
    return tuple(int(k[len("kernel_chunk"):])
                 for k in tune_candidates("ssd_scan")
                 if k.startswith("kernel_chunk"))


def _kv_block() -> int:
    from repro_torch.api.spec import JobSpec
    return next(f.default for f in dataclasses.fields(JobSpec)
                if f.name == "kv_block")


def train_attn_impl(cfg, mixer: str, batch: int, seq: int) -> str:
    """What ``attention(impl="auto")`` runs on a card for a training step
    of ``cfg`` (its compute dtype) at ``batch`` x ``seq``: ``"kernel"``
    where ``flash_attention_train.takes`` the mixer's q, k and v, else
    the plain path by length, as ``attention`` picks it."""
    from types import SimpleNamespace

    import torch

    from repro_torch.models.attention import AUTO_CHUNKED_ABOVE

    dtype = getattr(torch, cfg.dtype)
    H = cfg.num_heads
    if mixer.startswith("mla"):
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        shapes = ((H, dqk), (H, dqk), (H, cfg.v_head_dim))
    else:
        shapes = ((H, cfg.head_dim),) + ((cfg.num_kv_heads, cfg.head_dim),) * 2
    q, k, v = (SimpleNamespace(shape=(batch, seq) + hd, dtype=dtype,
                               device=torch.device("cuda"))
               for hd in shapes)
    if fat_k.takes(q, k, v, cfg.attn_softcap):
        return "kernel"
    return "chunked" if seq > AUTO_CHUNKED_ABOVE else "dense"


def registry_contracts(*, dtypes: Sequence[str] = ("bfloat16", "float32"),
                       batch: int = 1):
    """Contracts for every (op, arch, shape, dtype, slot) the port routes
    to a kernel.  Returns (contracts, findings raised while building them,
    audit, routes):
    audit maps op -> the contexts a contract was built under, routes holds
    every route, ``"dense"`` ones too."""
    from repro_torch.api.session import serve_attn_impl
    from repro_torch.models.attention import _window_for, decode_impl
    from repro_torch.models.blocks import RunConfig, _ssm_impl

    contracts: List[HopperContract] = []
    findings: List[Finding] = []
    audit: Dict[str, List[str]] = {}
    routes: List[Route] = []
    kv_block, chunks = _kv_block(), _tune_chunks()

    def add(op, ctx, impl, build=None):
        routes.append(Route(op, ctx, impl))
        if impl != "kernel":
            return
        c, fs = build(ctx)
        findings.extend(fs)
        if c is not None:
            contracts.append(c)
            audit.setdefault(op, []).append(ctx)

    for arch in ARCH_IDS:
        base = get_config(arch)
        for dtype in dtypes:
            cfg = base.replace(dtype=dtype)
            impl = serve_attn_impl(cfg, device="cuda")
            H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            dt = DTYPE_NAMES.get(dtype, dtype)
            mixers = sorted({s.mixer for s in cfg.pattern if s.mixer != "mamba"})
            for mixer in mixers:
                s = SHAPES["train_4k"].seq_len
                add("flash_attention_train",
                    f"flash_attention_train:{arch}:train_4k:{dt}:{mixer}",
                    train_attn_impl(cfg, mixer, batch, s),
                    lambda ctx, s=s: flash_train_contract(
                        B=batch, H=H, KV=KV, S=s, D=D, context=ctx))
                s = SHAPES["prefill_32k"].seq_len
                add("flash_attention",
                    f"flash_attention:{arch}:prefill_32k:{dt}:{mixer}", impl,
                    lambda ctx, s=s: flash_contract(
                        B=batch, H=H, KV=KV, Sq=s, Sk=s, D=D, context=ctx))
                window = _window_for(cfg, mixer)
                for shape in ("decode_32k", "long_500k"):
                    s_max = SHAPES[shape].seq_len
                    # the continuous engine's paged working cache is
                    # linear; the static engine folds a window shorter
                    # than s_max into a ring
                    caches = [(mixer, s_max)]
                    if window and window < s_max:
                        caches.append((f"{mixer}-ring", window))
                    for slot, s_cache in caches:
                        add("decode_attention",
                            f"decode_attention:{arch}:{shape}:{dt}:{slot}",
                            decode_impl(impl, s_cache, window, s_max),
                            lambda ctx, s_cache=s_cache: decode_contract(
                                B=batch, H=H, KV=KV, S=s_cache, D=D,
                                context=ctx))
                nb = SHAPES["decode_32k"].seq_len // kv_block
                add("paged_decode_attention",
                    f"paged_decode_attention:{arch}:decode_32k:{dt}:{mixer}",
                    impl, lambda ctx, nb=nb: paged_decode_contract(
                        B=batch, H=H, KV=KV, bs=kv_block, nb=nb, D=D,
                        context=ctx))
            if cfg.has_ssm:
                ssm_impl = _ssm_impl(RunConfig(attn_impl=impl))
                ssm_impl = "kernel" if ssm_impl == "kernel" else "dense"
                L = SHAPES["prefill_32k"].seq_len
                for chunk in dict.fromkeys((cfg.ssm_chunk,) + chunks):
                    add("ssd_scan",
                        f"ssd_scan:{arch}:prefill_32k:{dt}:chunk{chunk}",
                        ssm_impl, lambda ctx, chunk=chunk: ssd_contract(
                            B=batch, H=cfg.ssm_heads, L=L,
                            P=cfg.ssm_head_dim, N=cfg.ssm_state,
                            chunk=chunk, context=ctx))
    return contracts, findings, audit, routes


def check_registry(*, tunable_ops: Optional[Sequence[str]] = None, **kw):
    """Sweep the registry, check every contract, and flag any
    ``TUNABLE_OPS`` entry the sweep never covered (KC200).  Returns
    (findings, audit, routes)."""
    contracts, findings, audit, routes = registry_contracts(**kw)
    for c in contracts:
        findings.extend(check_contract(c))
    if tunable_ops is None:
        from repro_torch.kernels.ops import TUNABLE_OPS as tunable_ops
    for op in tunable_ops:
        if not audit.get(op):
            findings.append(Finding(
                path=KERNEL_FILES.get(op, "src/repro_torch/kernels/ops.py"),
                line=0, code="KC200",
                message=f"TUNABLE_OPS entry {op!r} has no kernel-contract "
                        "coverage", context=f"registry:{op}"))
    return findings, audit, routes


# ---------------------------------------------------------------------------
# KC207: 1F1B stage working set against Eq. 5's HBM budget
# ---------------------------------------------------------------------------


def pipeline_stage_findings(cfg, shape, *, pipe: int, n_microbatch: int,
                            dp: int, tp: int = 1, attn_impl: str = "flash",
                            remat: str = "block", chip: Chip = H100_SXM,
                            frac: float = 0.9,
                            context: str = "pipeline_stage") -> List[Finding]:
    """Every 1F1B stage of a pinned pipeline shape: its balanced-cut share
    of params, grads and optimizer state plus its activation working set
    (``memory_model.stage_activation_bytes``) must fit ``frac *
    hbm_bytes``.  One KC207 per stage that does not (JAX's KC107)."""
    from repro_torch.core.memory_model import n_params, stage_activation_bytes
    from repro_torch.core.pipeline import balanced_stage_cut

    op = "pipeline_stage"
    cycles = ((cfg.num_layers - cfg.first_k_dense)
              // max(len(cfg.pattern), 1))
    if pipe < 1 or cycles < pipe:
        return [_finding(op, "KC207",
                         f"pipe={pipe} does not cut {cycles} layer cycles "
                         "into non-empty stages", context)]
    cut = balanced_stage_cut(cycles, pipe)
    N = n_params(cfg)
    chips = dp * tp
    # per-stage static share (train_memory's conventions: bf16 + fp32
    # master weights, fp32 grads, ZeRO-1 adamw state)
    static = ((2 * N / tp + 4 * N / chips) + 4 * N / tp + 8 * N / chips) / pipe
    budget = frac * chip.hbm_bytes
    out: List[Finding] = []
    for s in range(pipe):
        act = stage_activation_bytes(
            cfg, shape, dp=dp, tp=tp, pipe=pipe, n_microbatch=n_microbatch,
            stage=s, stage_cycles=cut[s + 1] - cut[s], attn_impl=attn_impl,
            remat=remat, seq_parallel=True)
        ws = static + act
        if ws > budget:
            out.append(_finding(
                op, "KC207",
                f"stage {s}/{pipe} working set {ws:.3g} B (static "
                f"{static:.3g} + activations {act:.3g}, "
                f"{min(pipe - s, max(n_microbatch, pipe))} microbatches in "
                f"flight) exceeds the Eq.-5 budget {budget:.3g} B "
                f"(= {frac} * hbm)", context))
    return out


def check_pipeline_registry(cluster: str = "h100-8", *,
                            shapes: Sequence[str] = ("train_4k",)):
    """KC207's sweep, JAX's ``check_pipeline_registry`` on the cluster's
    chip and size: for every arch x pipe in {2, 4} x shape, the smallest
    microbatch count Eq. 5's gate (``memory_model.train_memory``, the
    planner's own check) accepts is audited per stage; cells the gate
    rejects at every count are skipped, as the planner skips them."""
    from repro_torch.core.memory_model import train_memory

    spec = CLUSTERS[cluster]
    chip, world = spec.chip, spec.n_chips
    findings: List[Finding] = []
    audit: Dict[str, List[str]] = {"pipeline_stage": []}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        cycles = ((cfg.num_layers - cfg.first_k_dense)
                  // max(len(cfg.pattern), 1))
        for pipe in (2, 4):
            if cycles < pipe or world % pipe:
                continue
            dp = world // pipe
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                ctx = f"pipeline_stage:{arch}:{shape_name}:p{pipe}"
                b_rep = max(shape.global_batch // dp, 1)
                m = pipe
                while m <= max(b_rep, pipe):
                    mem = train_memory(
                        cfg, shape, dp=dp, tp=1, fsdp=False, microbatch=0,
                        attn_impl="flash", remat="block", seq_parallel=True,
                        pipe=pipe, n_microbatch=m)
                    if mem.total <= 0.9 * chip.hbm_bytes:
                        audit["pipeline_stage"].append(f"{ctx}:m{m}")
                        findings.extend(pipeline_stage_findings(
                            cfg, shape, pipe=pipe, n_microbatch=m, dp=dp,
                            chip=chip, context=f"{ctx}:m{m}"))
                        break  # the smallest feasible m prices the cell
                    m *= 2
    return findings, audit


# ---------------------------------------------------------------------------
# KC208: the mirror against the .cu / .cuh text
# ---------------------------------------------------------------------------

_CONSTEXPR = re.compile(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);")
_OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
        ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a // b,
        ast.FloorDiv: lambda a, b: a // b}


def _int_expr(expr: str, names: Dict[str, int]) -> Optional[int]:
    """The value of a C integer constant expression of literals, names
    already read, + - * /; None for anything else."""
    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name):
            return names[n.id]
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            return _OPS[type(n.op)](ev(n.left), ev(n.right))
        raise ValueError(expr)
    try:
        return ev(ast.parse(expr.strip(), mode="eval").body)
    except (SyntaxError, ValueError, KeyError):
        return None


def source_constants(text: str) -> Dict[str, int]:
    """Every ``constexpr int NAME = <integer expression>;`` of a source."""
    names: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall(text):
        v = _int_expr(expr, names)
        if v is not None:
            names[name] = v
    return names


def _ints(pattern: str, text: str) -> Tuple[int, ...]:
    return tuple(sorted({int(m) for m in re.findall(pattern, text)}))


def _ternary(pattern: str, text: str, sizes: Sequence[int]
             ) -> Optional[Dict[int, int]]:
    """``D == a ? x : y`` read back as {D: x if D == a else y}."""
    m = re.search(pattern, text)
    if m is None:
        return None
    a, x, y = (int(g) for g in m.groups())
    return {d: x if d == a else y for d in sizes}


def read_sources(csrc: Path = CSRC) -> Dict[str, object]:
    """What the mirror copies, as the sources say it (None where a pattern
    is not found: that is drift too)."""
    fa = (csrc / "flash_attention.cu").read_text()
    ft = (csrc / "flash_attention_train.cu").read_text()
    tile = (csrc / "attention_tile.cuh").read_text()
    dec = (csrc / "decode_attention.cu").read_text()
    ssd = (csrc / "ssd_scan.cu").read_text()
    fa_c, ft_c, tile_c, ssd_c = (source_constants(t)
                                 for t in (fa, ft, tile, ssd))
    kp = re.search(r"kpitch\(\)\s*\{\s*return\s+D\s*\+\s*(\d+)\s*;", tile)
    g = re.search(r"H\s*/\s*KV\s*>\s*(\d+)", dec)
    r = re.search(r"R\s*>\s*(\d+)\s*\|\|", ssd)
    pairs = re.search(r"pairs_max\([^;]*?\)\s*>\s*NWARPS\s*/\s*(\d+)", ssd)
    return {
        "flash.BQ": fa_c.get("BQ"), "flash.BK": fa_c.get("BK"),
        "flash.NTHREADS": fa_c.get("NTHREADS"),
        "flash.D": _ints(r"launch<(\d+)>\(", fa),
        "flash.min_blocks": _ternary(
            r"__launch_bounds__\(NTHREADS,\s*D\s*==\s*(\d+)\s*\?\s*(\d+)"
            r"\s*:\s*(\d+)\)", fa, FLASH_D),
        "flash_train.BM": ft_c.get("BM"), "flash_train.BN": ft_c.get("BN"),
        "flash_train.TY": ft_c.get("TY"), "flash_train.TP": ft_c.get("TP"),
        "flash_train.D": _ints(r"fwd_kernel<(\d+)><<<", ft),
        "flash_train.min_blocks": _ternary(
            r"__launch_bounds__\(2\s*\*\s*D,\s*D\s*==\s*(\d+)\s*\?\s*"
            r"(\d+)\s*:\s*(\d+)\)", ft, FLASH_TRAIN_D),
        "tile.BK": tile_c.get("BK"), "tile.NWARPS": tile_c.get("NWARPS"),
        "tile.NTHREADS": tile_c.get("NTHREADS"),
        "tile.kpitch": int(kp.group(1)) if kp else None,
        "decode.D": _ints(r"launch<(\d+),\s*PAGED>\(", dec),
        "decode.stages": _ternary(
            r"stages\(\)\s*\{\s*return\s+D\s*==\s*(\d+)\s*\?\s*(\d+)\s*:"
            r"\s*(\d+)\s*;", dec, DECODE_D),
        "decode.MAX_G": int(g.group(1)) if g else None,
        "ssd.NWARPS": ssd_c.get("NWARPS"),
        "ssd.NTHREADS": ssd_c.get("NTHREADS"),
        "ssd.QMAX": ssd_c.get("QMAX"), "ssd.MAX_GROUP": ssd_c.get("MAX_GROUP"),
        "ssd.P": _ints(r"run_n<(\d+)>\(", ssd),
        "ssd.N": _ints(r"case\s+(\d+):\s*return\s+run<P,\s*\d+>", ssd),
        "ssd.max_R": int(r.group(1)) if r else None,
        "ssd.pair_div": int(pairs.group(1)) if pairs else None,
        "ssd.state_threads": _ints(r"state_pass<<<[^,]+,\s*(\d+)\s*,", ssd),
    }


def mirror_values() -> Dict[str, object]:
    """The same keys, as this module holds them."""
    return {
        "flash.BQ": FLASH["BQ"], "flash.BK": FLASH["BK"],
        "flash.NTHREADS": FLASH["NTHREADS"], "flash.D": FLASH_D,
        "flash.min_blocks": dict(FLASH_MIN_BLOCKS),
        "flash_train.BM": FLASH_TRAIN["BM"], "flash_train.BN": FLASH_TRAIN["BN"],
        "flash_train.TY": FLASH_TRAIN["TY"], "flash_train.TP": FLASH_TRAIN["TP"],
        "flash_train.D": FLASH_TRAIN_D,
        "flash_train.min_blocks": dict(FLASH_TRAIN_MIN_BLOCKS),
        "tile.BK": TILE["BK"], "tile.NWARPS": TILE["NWARPS"],
        "tile.NTHREADS": TILE["NTHREADS"], "tile.kpitch": KPITCH_PAD,
        "decode.D": DECODE_D, "decode.stages": dict(DECODE_STAGES),
        "decode.MAX_G": MAX_G,
        "ssd.NWARPS": SSD["NWARPS"], "ssd.NTHREADS": SSD["NTHREADS"],
        "ssd.QMAX": SSD["QMAX"], "ssd.MAX_GROUP": SSD["MAX_GROUP"],
        "ssd.P": SSD_P, "ssd.N": SSD_N, "ssd.max_R": SSD_MAX_R,
        "ssd.pair_div": SSD_PAIR_DIV, "ssd.state_threads": (STATE_THREADS,),
    }


def wrapper_values() -> Dict[str, object]:
    """The wrappers' own copies of the same sizes, as the mirror's keys."""
    return {
        "flash.D": tuple(_launch.HEAD_DIMS), "decode.D": tuple(_launch.HEAD_DIMS),
        "flash_train.D": tuple(fat_k.HEAD_DIMS),
        "tile.BK": dec_k.TILE, "ssd.P": tuple(ssd_k.P_SIZES),
        "ssd.N": tuple(ssd_k.N_SIZES), "ssd.QMAX": ssd_k.MAX_CHUNK,
        "ssd.MAX_GROUP": ssd_k.MAX_GROUP,
    }


_KEY_FILES = {"flash": "flash_attention.cu",
              "flash_train": "flash_attention_train.cu",
              "tile": "attention_tile.cuh",
              "decode": "decode_attention.cu", "ssd": "ssd_scan.cu"}


def mirror_drift(csrc: Path = CSRC) -> List[Finding]:
    """KC208: one finding per value where the mirror, or a wrapper's copy,
    differs from the source text."""
    text, mine, wrap = read_sources(Path(csrc)), mirror_values(), wrapper_values()
    out: List[Finding] = []
    for key, want in text.items():
        path = f"src/repro_torch/csrc/{_KEY_FILES[key.split('.')[0]]}"
        for who, got in (("the mirror", mine[key]),
                         ("the wrapper", wrap.get(key, want))):
            if got != want:
                out.append(Finding(
                    path=path, line=0, code="KC208",
                    message=f"{who} holds {key} = {got!r}, the source "
                            f"says {want!r}", context=f"mirror:{key}"))
    return out


# ---------------------------------------------------------------------------
# The card's side: the compiled kernels against the mirror
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CardCase:
    """One instantiation, as the card is asked about it."""
    op: str
    library: str
    query: str                  # the extern "C" query
    args: Tuple[int, ...]       # its size arguments
    launch: Launch              # the mirror's launch (grid unused)


def card_cases() -> List[CardCase]:
    """Every instantiation of B1-B4 and of the training attention's three
    kernels, with the dynamic shared memory its
    launch sets: B2's combine at the most splits ``decode_splits`` gives,
    B4's passes at the largest chunk and its row blocks."""
    out: List[CardCase] = []
    none = (0, 0, 0)
    for D in FLASH_D:
        out.append(CardCase(
            "flash_attention", "flash_attention", "flash_attention_query",
            (D,), Launch(f"flash_kernel<{D}>", none, FLASH["NTHREADS"],
                         flash_smem(D), min_blocks=FLASH_MIN_BLOCKS[D],
                         claimed_blocks=FLASH_CLAIM[D])))
    for D in FLASH_TRAIN_D:
        for kind_index, kind in enumerate(FLASH_TRAIN_KINDS):
            out.append(CardCase(
                "flash_attention_train", "flash_attention_train",
                "flash_train_query", (kind_index, D),
                flash_train_launch(kind, D)))
    splits = dec_k.TARGET_BLOCKS
    for D in DECODE_D:
        for kind, op in ((0, "decode_attention"),
                         (1, "paged_decode_attention")):
            out.append(CardCase(
                op, "decode_attention", "decode_attention_query",
                (kind, D, splits),
                Launch(f"decode_kernel<{D}, {str(bool(kind)).lower()}>",
                       none, TILE["NTHREADS"], decode_smem(D),
                       claimed_blocks=DECODE_CLAIM[D])))
        out.append(CardCase(
            "decode_attention", "decode_attention", "decode_attention_query",
            (2, D, splits), Launch(f"decode_combine_kernel<{D}>", none, D,
                                   splits * 4,
                                   static_smem=combine_static(D))))
    Q = SSD["QMAX"]
    R = ssd_k.launch_shape(1, 1, Q, Q)[2]
    for P in SSD_P:
        for N in SSD_N:
            out.append(CardCase(
                "ssd_scan", "ssd_scan", "ssd_scan_query", (1, P, N, Q, R),
                Launch(f"chunk_pass<{P}, {N}>", none, SSD["NTHREADS"],
                       chunk_smem(padded(Q), P, N))))
            out.append(CardCase(
                "ssd_scan", "ssd_scan", "ssd_scan_query", (3, P, N, Q, R),
                Launch(f"output_pass<{P}, {N}>", none, SSD["NTHREADS"],
                       output_smem(padded(Q), P, N, R))))
    out.append(CardCase("ssd_scan", "ssd_scan", "ssd_scan_query",
                        (2, SSD_P[0], SSD_N[0], Q, R),
                        Launch("state_pass", none, STATE_THREADS, 0)))
    return out


# what each query writes into its out array, in order
CARD_FIELDS = ("regs", "spill_bytes", "static_smem", "max_threads",
               "dyn_smem", "threads", "blocks_resident")


def card_check(device="cuda") -> List[Dict[str, object]]:
    """Ask the card about every instantiation of B1-B4 and hold the answer
    to the mirror.  Returns one row per instantiation: registers, spill
    bytes, static and dynamic shared memory, the blocks per SM the design
    claims and the blocks the runtime says can be resident, and the
    headroom under the 232,448 B a block can opt into.  Raises
    ``KernelError`` where the dynamic size a launch sets differs from the
    mirror's, where a block cannot be resident at all, or where the
    kernel takes fewer threads than its launch; a query the runtime
    refuses is a fault too.  Registers, spills and residency under the
    claim are measurements, not faults.  Raises without a card, as every
    entry point does."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models.common import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("card_check asks the card; pass a CUDA device")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rows: List[Dict[str, object]] = []
    faults: List[str] = []
    for case in card_cases():
        fn = getattr(_build.library(case.library), case.query)
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * len(CARD_FIELDS))()
        err = fn(*[ctypes.c_int(a) for a in case.args], ctypes.c_int(index),
                 out)
        ln = case.launch
        if err != 0:
            raise _build.KernelError(
                f"{case.query}{case.args} ({ln.kernel}): the runtime "
                f"refused the query with error {err}")
        got = dict(zip(CARD_FIELDS, (int(v) for v in out)))
        row = {"op": case.op, "kernel": ln.kernel, **got,
               "mirror_dyn_smem": ln.dyn_smem,
               "mirror_static_smem": ln.static_smem,
               "blocks_claimed": ln.claimed_blocks,
               "reg_cap": reg_cap(ln.threads, ln.min_blocks),
               "headroom": SMEM_OPTIN - got["dyn_smem"] - got["static_smem"]}
        rows.append(row)
        if got["dyn_smem"] != ln.dyn_smem:
            faults.append(f"{ln.kernel}: the launch sets {got['dyn_smem']} B "
                          f"of dynamic shared memory, the mirror says "
                          f"{ln.dyn_smem}")
        if got["threads"] != ln.threads:
            faults.append(f"{ln.kernel}: launched with {got['threads']} "
                          f"threads, the mirror says {ln.threads}")
        if got["blocks_resident"] < 1:
            faults.append(f"{ln.kernel}: no block can be resident "
                          f"({got['regs']} registers, {got['dyn_smem']} + "
                          f"{got['static_smem']} B shared)")
        if got["max_threads"] < ln.threads:
            faults.append(f"{ln.kernel}: takes at most {got['max_threads']} "
                          f"threads a block, the launch has {ln.threads}")
    if faults:
        raise _build.KernelError("kernel contracts broken on the card: "
                                 + "; ".join(faults))
    return rows


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def analyze(root=None) -> List[Finding]:
    """The analyzer interface of the CLI: the registry sweep (contracts
    come from the imported registry, not from ``root``), KC207's sweep,
    and KC208 over ``root``'s sources (this package's when ``root`` holds
    none)."""
    findings, _, _ = check_registry()
    findings += check_pipeline_registry()[0]
    csrc = Path(root) / "src" / "repro_torch" / "csrc" if root else CSRC
    findings += mirror_drift(csrc if (csrc / "ssd_scan.cu").exists() else CSRC)
    return sorted(findings)
