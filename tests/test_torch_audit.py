"""``python -m fedml_tpu_torch.cli audit``: the port's compiled-artifact
audit (``fedml_tpu_torch/analysis/compiled.py`` + ``audit.py``), mirroring
``tests/test_audit.py``'s classes:

- **planted executables**: one known-bad function per rule (a scalar
  read, a copy to the host and a data-dependent shape in a hot body; a
  large host constant; a census over budget), asserting the rule each
  checker reports from the fake-tensor trace, beside the known-good
  control (a cold executable may read the host; fills are free);
- **ratchet**: the findings ride lint's count-keyed baseline: NEW fails,
  STALE fails, counts ratchet, a baseline saves and loads;
- **never executes**: every tensor that reaches the recorder is fake,
  and the hand kernels' launch counters stay at 0;
- **the repo at HEAD and the JAX registry**: the same nine names, 16
  case keys and census budgets as ``fedml_tpu``'s; the FLOPs equal the
  JAX report's where the op sequence is the same, and elsewhere within
  the stated ratio; ``cli audit --ci --json`` exits 0, its report under
  ``tmp_path``.

Every planted function is traced on fake tensors and never called on
real ones.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from fedml_tpu_torch import cli as port_cli
from fedml_tpu_torch.analysis.audit import (
    AUDIT_BASELINE_NAME,
    AUDIT_REPORT_NAME,
    AUDIT_RULES,
    RULE_CENSUS,
    RULE_CONSTANT,
    RULE_HOST,
    RULES_LEFT_OUT,
    audit_spec,
    run_audit,
)
from fedml_tpu_torch.analysis.compiled import (
    AuditContext,
    AuditableSpec,
    LoweringCase,
    load_registry,
    lower_case,
    pow2_budget,
)
from fedml_tpu_torch.analysis.engine import diff_baseline, load_baseline, save_baseline
from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL, MEAN_KERNEL
from fedml_tpu_torch.ops.robust_term import TERM_KERNEL
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_PATH = "tests/test_torch_audit.py"
CTX = AuditContext()

# the FLOPs of the executables whose op sequence differs from XLA's (the
# port's vmapped step takes its gradients by bmm and sorts to shuffle;
# XLA fuses, simplifies and lowers each differently) stay within this
# factor of the JAX report's; measured 0.98-1.45 (PERF.md)
FLOPS_RATIO_BOUND = 2.0


def _sds(shape, dtype="float32"):
    return CTX.sds(shape, dtype)


def _spec(name, cases, **kw):
    return AuditableSpec(name=name, path=FIXTURE_PATH, provider=lambda ctx: list(cases), **kw)


def _rules(findings):
    return [f.rule for f in findings]


# -- planted executables, one per rule --------------------------------------------


def _item_fold(x):
    return x * x.sum().item()


def _cpu_fold(x):
    return x.cpu() * 2.0


def _nonzero_fold(x):
    return x[torch.nonzero(x > 0)[:, 0]].sum() + x


class TestHostTransferChecker:
    @pytest.mark.parametrize("fn, op", [
        (_item_fold, "aten._local_scalar_dense"),
        (_cpu_fold, "aten._to_copy (card to host)"),
        (_nonzero_fold, "aten.nonzero"),
    ])
    def test_host_reads_in_a_hot_executable(self, fn, op):
        findings, entries = audit_spec(
            _spec("fix.fold", [LoweringCase("b8", fn, (_sds((8,)),))], hot=True), CTX)
        assert _rules(findings) == [RULE_HOST]
        assert op in entries[0]["host_transfers"]
        assert "executable 'fix.fold'" in findings[0].message

    def test_cold_executable_may_read_the_host(self):
        findings, entries = audit_spec(
            _spec("fix.debug_fold", [LoweringCase("b8", _item_fold, (_sds((8,)),))],
                  hot=False), CTX)
        assert findings == [] and entries[0]["host_transfers"]

    def test_pure_device_executable_is_clean(self):
        case = LoweringCase("b8", lambda x: x @ x.T, (_sds((8, 8)),))
        findings, entries = audit_spec(_spec("fix.mm", [case]), CTX)
        assert findings == [] and entries[0]["host_transfers"] == []


class TestConstantChecker:
    def test_large_host_constant_is_a_finding(self):
        big = [float(i) for i in range(32768)]  # a 128 KiB host blob a call

        def fold(x):
            return x + torch.tensor(big, device=x.device)[: x.shape[0]]

        case = LoweringCase("b8", fold, (_sds((8,)),))
        findings, entries = audit_spec(_spec("fix.fold", [case]), CTX)
        assert _rules(findings) == [RULE_CONSTANT]
        assert entries[0]["max_constant_bytes"] == 32768 * 4

    def test_fills_are_free(self):
        """A fill (zeros, full, a repeated value) is XLA's splat: free."""

        def fold(x):
            n = x.shape[0]
            return (x + torch.zeros(65536, device=x.device)[:n]
                    + torch.full((65536,), 2.0, device=x.device)[:n]
                    + torch.tensor([1.5] * 65536, device=x.device)[:n])

        case = LoweringCase("b8", fold, (_sds((8,)),))
        findings, entries = audit_spec(_spec("fix.fold", [case]), CTX)
        assert findings == [] and entries[0]["max_constant_bytes"] == 0

    def test_budget_is_per_spec(self):
        small = [float(i) for i in range(64)]

        def fold(x):
            return x + torch.tensor(small, device=x.device)[: x.shape[0]]

        case = LoweringCase("b8", fold, (_sds((8,)),))
        findings, _ = audit_spec(_spec("fix.fold", [case], constant_budget_bytes=16), CTX)
        assert _rules(findings) == [RULE_CONSTANT]


class TestCensusChecker:
    def test_overflowing_census_is_a_finding(self):
        cases = [LoweringCase(f"b{b}", lambda x: x * 2.0, (_sds((b,)),)) for b in (3, 5, 7)]
        findings, _ = audit_spec(_spec("fix.fwd", cases, census_budget=2), CTX)
        assert RULE_CENSUS in _rules(findings)

    def test_callable_budget_and_pow2_span(self):
        assert pow2_budget((8, 512)) == 7
        assert pow2_budget((8, 32)) == 3
        cases = [LoweringCase(f"b{b}", lambda x: x * 2.0, (_sds((b,)),)) for b in (4, 8)]
        findings, _ = audit_spec(
            _spec("fix.fwd", cases, census_budget=lambda ctx: pow2_budget((4, 8))), CTX)
        assert findings == []


class TestStaticCost:
    def test_a_product_costs_what_xla_says(self):
        """a @ b at 16 x 16: 2 * 16^3 FLOPs and three 1 KiB tensors, as
        the JAX package's lowering reads them."""
        import jax

        case = LoweringCase("b16", lambda a, b: a @ b, (_sds((16, 16)), _sds((16, 16))))
        _, entries = audit_spec(_spec("fix.mm", [case]), CTX)
        e = entries[0]
        sds = jax.ShapeDtypeStruct((16, 16), "float32")
        cost = jax.jit(lambda a, b: a @ b).lower(sds, sds).cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        assert e["flops"] == cost["flops"] == 2 * 16 ** 3
        assert e["bytes_accessed"] == cost["bytes accessed"] == 3 * 16 * 16 * 4
        assert e["arithmetic_intensity"] == e["flops"] / e["bytes_accessed"]

    def test_elementwise_and_reductions_count_by_elements(self):
        case = LoweringCase("b8", lambda x: (x * 2.0 + 1.0).sum(), (_sds((8, 4)),))
        _, entries = audit_spec(_spec("fix.ew", [case]), CTX)
        assert entries[0]["flops"] == 32 + 32 + 32  # mul, add, then the sum's inputs

    def test_uncallable_fn_is_rejected(self):
        spec = _spec("fix.raw", [LoweringCase("b8", "not callable", (_sds((8,)),))])
        with pytest.raises(RuntimeError, match="fake-tensor trace failed"):
            audit_spec(spec, CTX)


# -- the ratchet ----------------------------------------------------------------------


class TestAuditBaseline:
    def _findings(self):
        findings, _ = audit_spec(
            _spec("fix.fold", [LoweringCase("b8", _item_fold, (_sds((8,)),))]), CTX)
        return findings

    def test_new_finding_fails_and_baselined_passes(self):
        findings = self._findings()
        new, stale = diff_baseline(findings, {})
        assert len(new) == 1 and not stale
        new, stale = diff_baseline(findings, {findings[0].key(): 1})
        assert not new and not stale

    def test_stale_entry_fails(self):
        findings = self._findings()
        new, stale = diff_baseline(findings, {findings[0].key(): 1,
                                              "gone:aot-host-transfer:fixed": 1})
        assert not new and stale == ["gone:aot-host-transfer:fixed"]

    def test_count_ratchet(self):
        findings = self._findings() * 2  # the same key twice (two cases)
        new, _ = diff_baseline(findings, {findings[0].key(): 1})
        assert len(new) == 1  # the second occurrence is NEW

    def test_save_and_load_roundtrip(self, tmp_path):
        findings = self._findings()
        path = str(tmp_path / AUDIT_BASELINE_NAME)
        save_baseline(path, findings, comment="audit fixture ledger")
        assert load_baseline(path) == {findings[0].key(): 1}
        assert json.load(open(path))["comment"] == "audit fixture ledger"


# -- never executes -------------------------------------------------------------------


class TestNeverExecutes:
    def test_a_case_is_traced_once_on_fakes(self):
        """A function that would fail on real data (its scalar read is
        answered with a zero) traces once, and sees only fake tensors."""
        from torch._subclasses.fake_tensor import is_fake

        seen = []

        def fwd(x):
            seen.append(is_fake(x))
            if x.sum().item() != 0:  # a real call would read a real sum
                raise AssertionError("executed")
            return x * 2.0

        art = lower_case(_spec("fix.fwd", []), LoweringCase("b8", fwd, (_sds((8,)),)))
        assert seen == [True] and art.real_inputs == [] and art.flops == 8 + 8

    def test_the_repo_audit_launches_nothing(self, port_report):
        """During the repo's audit every tensor that reached the recorder
        was fake, K1 and K3 were traced where the census reaches them, and
        their launch counters never moved."""
        report, counts = port_report
        assert counts == {"exact_fold": 0, "exact_weighted_mean": 0, "robust_term": 0}
        assert all(e["real_inputs"] == 0 for e in report["executables"])
        kernels = {(e["executable"], e["case"]): e["kernels"] for e in report["executables"]}
        assert kernels[("agg.fold_tree", "model")] == {"exact_fold": 1}
        assert kernels[("agg.weighted_term_clipped", "model")] == {"robust_term": 1}
        assert kernels[("agg.weighted_delta_term_clipped", "model")] == {"robust_term": 1}
        # one weighted mean a leaf of the LR model (weight and bias)
        assert kernels[("simulation.round_fn_mesh", "b8")] == {"exact_weighted_mean": 2}
        assert torch.cuda.is_initialized() is False


# -- the repo at HEAD, against the JAX registry ----------------------------------------


@pytest.fixture(scope="module")
def port_report():
    """The port's audit of the repo, once a module; the kernels' launch
    counts after it."""
    for k in (FOLD_KERNEL, MEAN_KERNEL, TERM_KERNEL):
        k.reset_launches()
    findings, report = run_audit()
    assert findings == []
    return report, {k.name: k.launches for k in (FOLD_KERNEL, MEAN_KERNEL, TERM_KERNEL)}


@pytest.fixture(scope="module")
def jax_report():
    """The JAX package's audit report, once a module (~9 s of lowering)."""
    from fedml_tpu.analysis.audit import run_audit as jax_run_audit

    findings, report = jax_run_audit()
    assert findings == []
    return report


def _by_case(report) -> dict:
    return {(e["executable"], e["case"]): e for e in report["executables"]}


class TestRepoAtHead:
    def test_registry_is_the_jax_registry(self):
        """The same nine names, the same census keys and budgets."""
        from fedml_tpu.analysis.compiled import AuditContext as JaxContext
        from fedml_tpu.analysis.compiled import load_registry as jax_registry

        ours, theirs = load_registry(), jax_registry()
        assert sorted(ours) == sorted(theirs) and len(ours) == 9
        ctx, jctx = AuditContext(), JaxContext()
        assert ctx.to_dict() == jctx.to_dict()
        for name in ours:
            a, b = ours[name], theirs[name]
            budgets = [s.census_budget(c) if callable(s.census_budget) else s.census_budget
                       for s, c in ((a, ctx), (b, jctx))]
            assert budgets[0] == budgets[1], name
            assert (a.round_shaped, a.hot) == (b.round_shaped, b.hot), name
            assert a.path == b.path.replace("fedml_tpu/", "fedml_tpu_torch/", 1), name
        ctx.close()

    def test_the_same_sixteen_cases_as_jax(self, port_report, jax_report):
        ours, theirs = _by_case(port_report[0]), _by_case(jax_report)
        assert sorted(ours) == sorted(theirs) and len(ours) == 16
        assert ([(r["executable"], r["case"]) for r in port_report[0]["roofline"]]
                == [(r["executable"], r["case"]) for r in jax_report["roofline"]])

    @pytest.mark.parametrize("name, case, flops", [
        ("serving.forward", "b4", 272.0), ("serving.forward", "b16", 1088.0),
        ("agg.weighted_term", "model", 36.0), ("agg.fold_tree", "model", 468.0),
    ])
    def test_flops_equal_jax_where_the_ops_are_the_same(self, port_report, jax_report,
                                                        name, case, flops):
        assert _by_case(port_report[0])[(name, case)]["flops"] == flops
        assert _by_case(jax_report)[(name, case)]["flops"] == flops

    def test_flops_elsewhere_within_the_stated_ratio(self, port_report, jax_report):
        ours, theirs = _by_case(port_report[0]), _by_case(jax_report)
        for key in sorted(ours):
            ratio = ours[key]["flops"] / theirs[key]["flops"]
            print(f"{key[0]} {key[1]}: port {ours[key]['flops']:.0f} FLOPs, "
                  f"jax {theirs[key]['flops']:.0f}, ratio {ratio:.3f}")
            assert 1 / FLOPS_RATIO_BOUND <= ratio <= FLOPS_RATIO_BOUND, key

    def test_the_report_keeps_the_jax_keys_and_names_what_it_left_out(self, port_report,
                                                                      jax_report):
        report = port_report[0]
        assert set(jax_report) - set(report) == {"jax_version"}
        assert set(report) - set(jax_report) == {"torch_version", "lowering",
                                                 "rules_left_out", "fake_device"}
        assert report["platform"] == "cuda" and report["fake_device"] == "meta"
        assert set(report["rules_left_out"]) == {"aot-donation"} == set(RULES_LEFT_OUT)
        assert AUDIT_RULES == (RULE_HOST, RULE_CENSUS, RULE_CONSTANT)
        for e in report["executables"]:
            assert e["aliased_inputs"] is None and e["claimed_donated_leaves"] is None
            assert e["host_transfers"] == [] and e["flops"] > 0

    def test_audit_baseline_is_empty(self):
        assert load_baseline(os.path.join(REPO, AUDIT_BASELINE_NAME)) == {}

    def test_only_subset_and_unknown_name(self):
        findings, report = run_audit(only=["agg.weighted_term"])
        assert [e["executable"] for e in report["executables"]] == ["agg.weighted_term"]
        assert findings == []
        with pytest.raises(KeyError, match="unknown auditable"):
            run_audit(only=["nope.missing"])

    def test_cli_audit_ci_json_exits_zero_at_head(self, tmp_path, capsys):
        report = tmp_path / "report.json"
        assert port_cli.main(["audit", "--ci", "--json", "--report", str(report)]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["ok"] is True and out["new"] == [] and out["stale"] == []
        assert out["executables"] == 16 and out["report"] == str(report)
        data = json.loads(report.read_text())
        assert data["executables"] and data["roofline"]
        assert not os.path.exists(os.path.join(REPO, "audit_report.json")) or (
            json.load(open(os.path.join(REPO, "audit_report.json")))["tool"] == "fedml-tpu audit")
        assert AUDIT_REPORT_NAME == "audit_report_torch.json"

    def test_cli_only_and_rejected_flag_pairs(self, capsys):
        assert port_cli.main(["audit", "--only", "agg.weighted_term"]) == 0
        assert port_cli.main(["audit", "--ci", "--update-baseline"]) == 2
        assert port_cli.main(["audit", "--only", "agg.weighted_term", "--update-baseline"]) == 2
        assert port_cli.main(["audit", "--only", "nope.missing"]) == 2
        capsys.readouterr()
