"""The port's static analysis (``repro_torch.analysis``) against JAX's
(``repro.analysis``) on the same inputs, one known-bad case per rule the
port adds, and the ``tools/torch_lint.py`` gate on the repo.  Fast: no
process is started and nothing is compiled."""
import dataclasses
import importlib.util
import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import determinism as jax_dt
from repro.analysis import findings as jax_findings
from repro.analysis import kernel_contracts as jax_kc
from repro.analysis import schema_drift as jax_sd
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_shape as jax_get_shape
from repro.core.hardware import TPU_V5E as JAX_TPU_V5E
from repro_torch.analysis import determinism, findings, kernel_contracts as kc
from repro_torch.analysis import run_analyzers, schema_drift
from repro_torch.configs.base import get_config, get_shape
from repro_torch.core.hardware import TPU_V5E
from repro_torch.kernels.ops import TUNABLE_OPS

REPO = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# JAX's own fixtures, so both packages see the same sources
FIX = _load("_jax_analysis_fixtures", REPO / "tests" / "test_analysis.py")


def codes(fs):
    return sorted({f.code for f in fs})


def rows(fs):
    return [(f.code, f.line, f.context) for f in fs]


# ---------------------------------------------------------------------------
# Findings and baselines cross the packages
# ---------------------------------------------------------------------------


def test_findings_and_baselines_cross_packages():
    assert findings.FINDINGS_SCHEMA_ID == jax_findings.FINDINGS_SCHEMA_ID
    assert findings.BASELINE_SCHEMA_ID == jax_findings.BASELINE_SCHEMA_ID
    args = [("src/a.py", 10, "DT102", "clock", "f"),
            ("src/b.py", 20, "DT101", "rng", "g"),
            ("src/c.py", 0, "KC201", "size", "op:arch:shape")]
    mine = [findings.Finding(*a) for a in args]
    theirs = [jax_findings.Finding(*a) for a in args]
    assert [f.fingerprint for f in mine] == [f.fingerprint for f in theirs]
    for make, (a, b) in ((findings, (mine, theirs)),
                         (jax_findings, (theirs, mine))):
        doc = make.make_baseline(a[:2], {a[0].fingerprint: "justified"})
        findings.validate_baseline(doc)
        jax_findings.validate_baseline(doc)
        payload = make.make_findings_payload(a[:1], a[1:], ["X:y:z"], 0.5)
        findings.validate_findings(payload)
        jax_findings.validate_findings(payload)
    sup = {mine[0].fingerprint: "r", "X:gone:ctx": "stale"}
    got = findings.apply_baseline(mine, sup)
    want = jax_findings.apply_baseline(theirs, sup)
    assert ([f.to_dict() for f in got[0]], [f.to_dict() for f in got[1]],
            got[2]) == ([f.to_dict() for f in want[0]],
                        [f.to_dict() for f in want[1]], want[2])


# ---------------------------------------------------------------------------
# Determinism: JAX's fixtures through both analyzers, then torch's rules
# ---------------------------------------------------------------------------

_DT_CASES = {
    "bad_rng": (FIX.DT_BAD_RNG, "fix.py", 4),
    "good_rng": (FIX.DT_GOOD_RNG, "fix.py", 0),
    "bad_clock": (FIX.DT_BAD_CLOCK, "fix.py", 2),
    "clock_module_exempt": (FIX.DT_BAD_CLOCK, "obs/trace.py", 0),
    "good_clock": (FIX.DT_GOOD_CLOCK, "fix.py", 0),
    "bad_write": (FIX.DT_BAD_WRITE, "checkpoint/fix.py", 2),
    "good_write": (FIX.DT_GOOD_WRITE, "checkpoint/fix.py", 0),
    "write_outside_checkpoint": (FIX.DT_BAD_WRITE, "fix.py", 0),
}


@pytest.mark.parametrize("case", sorted(_DT_CASES))
def test_determinism_parity_on_jax_fixtures(case):
    src, rel, n = _DT_CASES[case]
    theirs = jax_dt.analyze_source(src, f"src/repro/{rel}")
    mine = determinism.analyze_source(src, f"src/repro_torch/{rel}")
    assert rows(mine) == rows(theirs) and len(mine) == n


def _dedent(s):
    return textwrap.dedent(s).lstrip()


TORCH_BAD = _dedent("""
    import torch
    import torch.distributed as dist

    def draws(w):
        a = torch.randn(4)
        b = torch.randperm(8)
        torch.manual_seed(0)
        w.normal_()
        torch.nn.init.uniform_(w)
        return a, b

    def sync_phase(t):
        dist.all_reduce(t)
        return t.sum().item(), t.tolist(), t.cpu()

    def group_phase(group, t):
        group.all_reduce(t)
        torch.cuda.synchronize()
        return float(t[0])
""")

TORCH_GOOD = _dedent("""
    import torch
    import torch.distributed as dist

    def draws(w, seed):
        g = torch.Generator().manual_seed(seed)
        w.normal_(generator=g)
        return torch.randn(4, generator=g), torch.randperm(8, generator=g)

    def sync_phase(t):
        dist.all_reduce(t)
        return t

    def report(t):
        return t.item(), float(t.sum())  # no collective in this scope
""")

CKPT_BAD = _dedent("""
    import torch

    def save(state, path):
        torch.save(state, path)
""")

CKPT_GOOD = _dedent("""
    import os
    import torch

    def save(state, path):
        torch.save(state, f"{path}.tmp")
        os.replace(f"{path}.tmp", path)
""")


def test_dt101_torch_global_rng_draws():
    found = [f for f in determinism.analyze_source(
        TORCH_BAD, "src/repro_torch/fix.py") if f.code == "DT101"]
    assert [f.line for f in found] == [5, 6, 7, 8, 9]
    assert {f.context for f in found} == {"draws"}


def test_dt103_host_sync_beside_a_torch_collective():
    found = [f for f in determinism.analyze_source(
        TORCH_BAD, "src/repro_torch/fix.py") if f.code == "DT103"]
    assert [(f.context, f.line) for f in found] == [
        ("sync_phase", 14)] * 3 + [("group_phase", 18), ("group_phase", 19)]


def test_torch_rules_known_good_is_clean():
    assert determinism.analyze_source(TORCH_GOOD,
                                      "src/repro_torch/fix.py") == []


def test_dt104_torch_save_needs_an_atomic_rename():
    bad = determinism.analyze_source(CKPT_BAD,
                                     "src/repro_torch/checkpoint/fix.py")
    assert rows(bad) == [("DT104", 4, "save")]
    assert determinism.analyze_source(
        CKPT_GOOD, "src/repro_torch/checkpoint/fix.py") == []
    assert determinism.analyze_source(CKPT_BAD, "src/repro_torch/fix.py") == []


# ---------------------------------------------------------------------------
# Schema drift
# ---------------------------------------------------------------------------


def test_schema_ids_are_jaxs_and_literals_agree():
    known, jax_known = schema_drift.known_schema_ids(), \
        jax_sd.known_schema_ids()
    assert set(known) == set(jax_known)
    pairs = schema_drift.scanned_sources(REPO) + [
        ("src/repro_torch/phantom.py", 'SCHEMA_ID = "repro.api/phantom/v9"\n')]
    mine = schema_drift.analyze_literals(pairs, known)
    theirs = jax_sd.analyze_literals(pairs, jax_known)
    assert rows(mine) == rows(theirs) == [
        ("SD101", 1, "repro.api/phantom/v9")]
    # a registered id nothing emits: the same dead registration in both
    few = [p for p in pairs[:-1] if "campaign" not in p[0]]
    assert [(f.code, f.context) for f in schema_drift.analyze_literals(
        few, known)] == [(f.code, f.context) for f in jax_sd.analyze_literals(
            few, jax_known)] == [("SD102", "repro.api/campaign/v1")]


def test_schema_clean_on_repo_and_goldens_validate_under_the_port():
    assert schema_drift.check_goldens(REPO) == []
    assert schema_drift.check_histogram_keys() == []
    assert schema_drift.analyze(REPO) == []


def test_sd104_sd105_goldens(tmp_path):
    g = tmp_path / "tests" / "goldens"
    g.mkdir(parents=True)
    (g / "report_broken.json").write_text('{"schema": "nope"}')
    (g / "mystery_thing.json").write_text("{}")
    assert codes(schema_drift.check_goldens(tmp_path)) == ["SD104", "SD105"]


# ---------------------------------------------------------------------------
# Kernel contracts
# ---------------------------------------------------------------------------


def test_kc207_equals_jax_kc107_on_the_same_chip():
    tiny = dataclasses.replace(TPU_V5E, hbm_bytes=2 * 2 ** 30)
    jax_tiny = dataclasses.replace(JAX_TPU_V5E, hbm_bytes=2 * 2 ** 30)
    for chip, jax_chip, pipe, m in ((TPU_V5E, JAX_TPU_V5E, 2, 4),
                                    (tiny, jax_tiny, 4, 64)):
        mine = kc.pipeline_stage_findings(
            get_config("granite-3-2b"), get_shape("train_4k"), pipe=pipe,
            n_microbatch=m, dp=2, chip=chip, context="fixture")
        theirs = jax_kc.pipeline_stage_findings(
            jax_get_config("granite-3-2b"), jax_get_shape("train_4k"),
            pipe=pipe, n_microbatch=m, dp=2, chip=jax_chip,
            context="fixture")
        assert [(f.message, f.context) for f in mine] == \
            [(f.message, f.context) for f in theirs]
        assert {f.code for f in theirs} <= {"KC107"}
        assert {f.code for f in mine} <= {"KC207"}
    assert len(mine) == 4  # every stage flags on the tiny chip


def _launch_contract(**kw):
    launch = kc.Launch("fixture<64>", (1, 1, 1), **kw)
    return kc.HopperContract("flash_attention", "fixture", (("D", 64),),
                             (launch,))


def _doctored_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kc.CSRC, csrc)
    fa = csrc / "flash_attention.cu"
    fa.write_text(fa.read_text().replace("constexpr int BQ = 128;",
                                         "constexpr int BQ = 64;"))
    dec = csrc / "decode_attention.cu"
    dec.write_text(dec.read_text().replace("D == 64 ? 4 : 3", "D == 64 ? 4 : 2"))
    return csrc


_FIRES = {
    "KC200": lambda tmp: kc.check_registry(
        tunable_ops=tuple(TUNABLE_OPS) + ("phantom_op",))[0],
    "KC201": lambda tmp: kc.decode_contract(B=1, H=128, KV=1, S=32768,
                                            D=576, context="fixture")[1],
    "KC202": lambda tmp: kc.check_contract(_launch_contract(
        threads=256, dyn_smem=240_000)),
    "KC203": lambda tmp: kc.check_contract(_launch_contract(
        threads=256, dyn_smem=1024, min_blocks=1, claimed_blocks=2)),
    "KC204": lambda tmp: kc.check_contract(kc.flash_contract(
        B=70_000, H=8, KV=2, Sq=128, Sk=128, D=64, context="fixture")[0]),
    "KC205": lambda tmp: kc.flash_contract(B=1, H=7, KV=2, Sq=128, Sk=128,
                                           D=64, context="fixture")[1],
    "KC206": lambda tmp: kc.check_contract(kc.ssd_contract(
        B=64, H=256, L=32768, P=64, N=128, chunk=32, context="fixture")[0]),
    "KC207": lambda tmp: kc.pipeline_stage_findings(
        get_config("granite-3-2b"), get_shape("train_4k"), pipe=41,
        n_microbatch=82, dp=1, context="fixture"),
    "KC208": lambda tmp: kc.mirror_drift(_doctored_csrc(tmp)),
}


@pytest.mark.parametrize("code", sorted(_FIRES))
def test_each_kc2xx_rule_fires(code, tmp_path):
    assert codes(_FIRES[code](tmp_path)) == [code]


@pytest.mark.parametrize("build,why", [
    (lambda: kc.decode_contract(B=1, H=64, KV=2, S=4096, D=128), "at most 16"),
    (lambda: kc.flash_contract(B=1, H=8, KV=8, Sq=64, Sk=64, D=96), "D=96"),
    (lambda: kc.ssd_contract(B=1, H=8, L=512, P=128, N=64, chunk=64), "P=128"),
    (lambda: kc.ssd_contract(B=1, H=8, L=512, P=64, N=256, chunk=64), "N=256"),
    (lambda: kc.ssd_contract(B=1, H=8, L=500, P=64, N=64, chunk=64),
     "not a multiple of the chunk"),
    (lambda: kc.ssd_contract(B=1, H=8, L=510, P=64, N=64, chunk=102),
     "multiple of 4"),
])
def test_kc201_sizes_without_an_instantiation(build, why):
    c, found = build()
    assert c is None and codes(found) == ["KC201"] and why in found[0].message


def test_kc208_names_what_drifted(tmp_path):
    assert kc.mirror_drift() == []
    got = {f.context for f in kc.mirror_drift(_doctored_csrc(tmp_path))}
    assert got == {"mirror:flash.BQ", "mirror:decode.stages"}


def test_contracts_mirror_the_wrappers_sizing():
    # mamba2-780m at prefill_32k: three passes, the output pass within
    # 13 KB of the opt-in limit
    c, _ = kc.ssd_contract(B=1, H=48, L=32768, P=64, N=128, chunk=256)
    assert [ln.kernel for ln in c.launches] == [
        "chunk_pass<64, 128>", "state_pass", "output_pass<64, 128>"]
    assert c.launches[-1].dyn_smem == 219_136
    assert kc.SMEM_OPTIN - c.launches[-1].dyn_smem == 13_312
    one, _ = kc.ssd_contract(B=1, H=48, L=192, P=64, N=128, chunk=256)
    assert [ln.kernel for ln in one.launches] == [
        "chunk_pass<64, 128>", "output_pass<64, 128>"]
    # B2: a combine pass with its scratch only when the walk is split
    long, _ = kc.decode_contract(B=1, H=32, KV=8, S=32768, D=64)
    assert long.launches[1].kernel == "decode_combine_kernel<64>"
    assert long.scratch_bytes == dict(long.sizes)["splits"] * 32 * 66 * 4
    short, _ = kc.decode_contract(B=1, H=32, KV=8, S=64, D=64)
    assert len(short.launches) == 1 and short.scratch_bytes == 0
    assert kc.flash_contract(B=1, H=8, KV=2, Sq=64, Sk=64, D=64)[0] \
        .launches[0].dyn_smem == 50_176
    assert kc.check_contract(c) == kc.check_contract(long) == []


def test_registry_sweep_is_clean_and_audits_every_tunable_op():
    found, audit, routes = kc.check_registry()
    assert found == [], [str(f) for f in found]
    for op in TUNABLE_OPS:
        archs = {ctx.split(":")[1] for ctx in audit[op]}
        assert len(archs) >= 2, (op, audit[op])
    pipe_found, pipe_audit = kc.check_pipeline_registry()
    assert pipe_found == [] and len(pipe_audit["pipeline_stage"]) >= 3


def test_dense_routes_have_no_contract():
    _, audit, routes = kc.check_registry()
    impl = {r.context: r.impl for r in routes}
    contracted = {c for ctxs in audit.values() for c in ctxs}
    for arch in ("deepseek-v2-236b", "minicpm3-4b"):  # MLA, any dtype
        for dt in ("bf16", "fp32"):
            ctx = f"decode_attention:{arch}:decode_32k:{dt}:mla"
            assert impl[ctx] == "dense" and ctx not in contracted
    for ctx in ("flash_attention:granite-3-2b:prefill_32k:fp32:attn",
                "ssd_scan:mamba2-780m:prefill_32k:fp32:chunk256",
                "decode_attention:gemma2-27b:decode_32k:bf16:swa-ring"):
        assert impl[ctx] == "dense" and ctx not in contracted
    for ctx in ("flash_attention:granite-3-2b:prefill_32k:bf16:attn",
                "ssd_scan:mamba2-780m:prefill_32k:bf16:chunk32",
                "decode_attention:gemma2-27b:decode_32k:bf16:swa"):
        assert impl[ctx] == "kernel" and ctx in contracted
    # JAX admits the absorbed MLA decode at D = 576; the port has no such
    # instantiation, so a forced contract is a finding
    c, found = kc.decode_contract(B=1, H=128, KV=1, S=32768, D=576)
    assert c is None and codes(found) == ["KC201"]


def test_card_check_raises_without_a_card():
    with pytest.raises(ValueError):
        kc.card_check("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            kc.card_check("cuda")


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_repo_self_run_is_clean():
    found = run_analyzers(REPO)
    sup = findings.load_baseline(REPO / "tools" / "torch_lint_baseline.json")
    unbaselined, suppressed, stale = findings.apply_baseline(found, sup)
    assert unbaselined == [] and stale == [], [str(f) for f in unbaselined]
    assert all("src/repro/" in r for r in sup.values())  # JAX's counterpart


def test_cli_exits_zero_on_repo_and_one_on_a_bad_tree(tmp_path, capsys):
    cli = _load("_torch_lint", REPO / "tools" / "torch_lint.py")
    out = tmp_path / "findings.json"
    assert cli.main(["--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    findings.validate_findings(payload)
    jax_findings.validate_findings(payload)
    assert payload["clean"] and payload["findings"] == []
    bad = tmp_path / "tree" / "src" / "repro_torch"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(FIX.DT_BAD_CLOCK + TORCH_BAD)
    assert cli.main(["--root", str(tmp_path / "tree"),
                     "--analyzer", "determinism"]) == 1
    capsys.readouterr()
