"""`python -m fedml_tpu_torch.cli lint` — the port's static-analysis suite
(``fedml_tpu_torch/analysis/``) against the JAX package's
``fedml_tpu/analysis/``, on the CPU.

- the shared rules (``except``, ``determinism``, ``thread-lock``,
  ``registry``, and ``host-sync`` on the constructs both flag): the JAX
  package's fixture snippets (tests/test_lint.py) go through both
  packages' checkers, with ``fedml_tpu/`` mapped to ``fedml_tpu_torch/``,
  and give the same findings: rule, line and message;
- the engine: suppressions, ``diff_baseline`` and the JSON payload agree;
- the torch rules: ``host-sync``'s torch syncs and ``determinism``'s
  global torch generator, on torch fixtures;
- the tree: the port lints clean against ``lint_baseline_torch.json``, a
  bare ``except`` planted in an in-memory copy of its corpus is a new
  finding (the tree is never written), ``cli lint --ci --json`` exits 0,
  and the analysis modules import nothing but the standard library.

Planted bad code lives in string literals only.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import os
import sys
import textwrap

import pytest

from fedml_tpu.analysis import determinism as jax_determinism
from fedml_tpu.analysis import engine as jax_engine
from fedml_tpu.analysis import exceptions as jax_exceptions
from fedml_tpu.analysis import hostsync as jax_hostsync
from fedml_tpu.analysis import registry as jax_registry
from fedml_tpu.analysis import threads as jax_threads
from fedml_tpu_torch.analysis import determinism, engine, exceptions, hostsync, registry, threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS = os.path.join(REPO, "fedml_tpu_torch", "analysis")


def _port_path(path: str) -> str:
    return "fedml_tpu_torch/" + path[len("fedml_tpu/"):] if path.startswith("fedml_tpu/") else path


def _both(check, jax_check, path, src):
    """(port findings, JAX findings) of one snippet as (line, rule,
    message) with the path mapped."""
    src = textwrap.dedent(src)
    jax_fs = jax_check(jax_engine.ModuleSource.parse(path, src))
    port_fs = check(engine.ModuleSource.parse(_port_path(path), src))
    assert all(f.path == _port_path(path) for f in port_fs)
    assert all(f.path == path for f in jax_fs)
    return ([(f.line, f.rule, f.message) for f in port_fs],
            [(f.line, f.rule, f.message) for f in jax_fs])


# -- the JAX package's fixtures through both packages --------------------------

SEEDED = "fedml_tpu/scale/registry.py"
CORE = "fedml_tpu/core/x.py"
HOT = "fedml_tpu/core/aggregation.py"

DETERMINISM_FIXTURES = [
    (SEEDED, """\
        import time, random
        import numpy as np
        def sample(n):
            t = time.time()
            np.random.seed(0)
            r = np.random.rand(n)
            j = random.random()
            return t, r, j
        """, 4),
    (SEEDED, """\
        import time, random
        import numpy as np
        def sample(n, seed):
            rs = np.random.RandomState(seed)
            g = np.random.default_rng(seed)
            r = random.Random(seed)
            t = time.monotonic()
            return rs.rand(n), g, r, t
        """, 0),
    ("fedml_tpu/core/telemetry.py", "import time\nt = time.time()\n", 0),
]

EXCEPT_FIXTURES = [
    (CORE, """\
        def f():
            try:
                g()
            except:
                pass
        """, 2),
    (CORE, """\
        import logging
        def f(tel):
            try:
                g()
            except OSError:
                logging.debug("g failed", exc_info=True)
            try:
                g()
            except ValueError:
                tel.inc("x_internal_errors_total")
            try:
                g()
            except KeyError:
                raise RuntimeError("ctx")
        """, 0),
    (CORE, """\
        import queue
        def f(q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
            return item
        """, 0),
]

THREAD_FIXTURES = [
    (CORE, """\
        import threading
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._thread = threading.Thread(target=self._loop)
            def _loop(self):
                while True:
                    self.count += 1
            def snapshot(self):
                return self.count
        """, 2),
    (CORE, """\
        import threading
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._thread = threading.Thread(target=self._loop)
            def _loop(self):
                while True:
                    with self._lock:
                        self.count += 1
            def snapshot(self):
                with self._lock:
                    return self.count
        """, 0),
    (CORE, """\
        import threading
        class Worker:
            def __init__(self):
                self._thread = threading.Thread(target=self._loop)
            def _loop(self):
                self.scratch = 0
                self.scratch += 1
        """, 0),
    (CORE, """\
        import threading
        class Worker:
            def arm(self):
                def fire():
                    self.fired = True
                t = threading.Timer(1.0, fire)
                t.start()
            def check(self):
                return self.fired
        """, 2),
    (CORE, """\
        import threading
        class Worker:
            def start(self):
                self._thread = threading.Thread(target=self._loop)
            def _loop(self):
                self._thread = None
            def stop(self):
                return self._thread
        """, 0),
]

# the JAX host-sync fixtures whose constructs both packages flag alike
HOSTSYNC_FIXTURES = [
    (HOT, """\
        import numpy as np
        def fold(x):
            a = float(x)
            b = x.item()
            c = np.asarray(x)
            return a, b, c
        """, 3),
    (HOT, """\
        import jax.numpy as jnp
        def fold(x, losses):
            a = float(x.sum())
            b = float(jnp.sum(x))
            c = float(losses.get("k"))
            d = int(sum([1, 2]))
            return a, b, c, d
        """, 3),
    (HOT, """\
        def fold(args, x):
            lr = float(args.learning_rate)
            n = int(x.shape[0])
            k = int(len(x))
            c = float(1.0 / 3)
            return lr, n, k, c
        """, 0),
    (HOT, """\
        class Acc:
            def __init__(self, q):
                self.q = float(q)
        """, 0),
    ("fedml_tpu/core/telemetry.py", "def f(x):\n    return float(x)\n", 0),
    (HOT, """\
        def fold(x):
            a = float(x)  # lint: host-sync-ok
            b = float(x)
            return a, b
        """, 1),
    (HOT, """\
        def fold(x):
            # lint: host-sync-ok
            a = float(x)
            b = float(x)
            return a, b
        """, 1),
]


def _suppressed(engine_mod, path, src, check):
    mod = engine_mod.ModuleSource.parse(path, textwrap.dedent(src))
    return [f for f in check(mod) if not mod.is_suppressed(f.rule, f.line)]


@pytest.mark.parametrize("case", range(len(DETERMINISM_FIXTURES)))
def test_determinism_fixtures_match_jax(case):
    path, src, n = DETERMINISM_FIXTURES[case]
    port, jax = _both(determinism.check_determinism, jax_determinism.check_determinism,
                      path, src)
    assert port == jax and len(port) == n


@pytest.mark.parametrize("case", range(len(EXCEPT_FIXTURES)))
def test_except_fixtures_match_jax(case):
    path, src, n = EXCEPT_FIXTURES[case]
    port, jax = _both(exceptions.check_exceptions, jax_exceptions.check_exceptions, path, src)
    assert port == jax and len(port) == n


@pytest.mark.parametrize("case", range(len(THREAD_FIXTURES)))
def test_thread_lock_fixtures_match_jax(case):
    path, src, n = THREAD_FIXTURES[case]
    port, jax = _both(threads.check_thread_shared_state,
                      jax_threads.check_thread_shared_state, path, src)
    assert port == jax and len(port) == n


@pytest.mark.parametrize("case", range(len(HOSTSYNC_FIXTURES)))
def test_host_sync_fixtures_match_jax(case):
    path, src, n = HOSTSYNC_FIXTURES[case]
    port = _suppressed(engine, _port_path(path), src, hostsync.check_host_sync)
    jax = _suppressed(jax_engine, path, src, jax_hostsync.check_host_sync)
    assert [(f.line, f.rule, f.message) for f in port] == [
        (f.line, f.rule, f.message) for f in jax]
    assert len(port) == n


REGISTRY_CORPORA = {
    "orphan": ([("fedml_tpu/constants.py", "MSG_TYPE_A = 1\nMSG_TYPE_ORPHAN = 2\n"),
                ("fedml_tpu/core/m.py", """\
                    from .. import constants
                    class M:
                        def register(self):
                            self.register_message_receive_handler(
                                constants.MSG_TYPE_A, self.h)
                    """)], ""),
    "comparison": ([("fedml_tpu/constants.py", "MSG_TYPE_ACK = 50\n"),
                    ("fedml_tpu/core/comm/r.py", """\
                        from ... import constants
                        def on_msg(t):
                            return t == constants.MSG_TYPE_ACK
                        """)], ""),
    "naming": ([("fedml_tpu/constants.py", ""),
                ("fedml_tpu/core/t.py", """\
                    def f(tel):
                        tel.inc("good_things_total")
                        tel.inc("bad_things")
                        tel.set_gauge("depth_now_total")
                        tel.observe("latency")
                        tel.observe("wire_utilization_fraction")
                    """)], "`good_things_total` docs"),
    "knobs": ([("fedml_tpu/constants.py", ""),
               ("fedml_tpu/core/k.py", """\
                   def f(args):
                       a = args.comm_round
                       b = getattr(args, "mystery_knob", 3)
                       args.derived_at_runtime = 1
                       c = args.derived_at_runtime
                       d = args.rank
                       e = args.get("other_mystery")
                       return a, b, c, d, e
                   """),
               ("fedml_tpu/cli.py", "def f(args):\n    return args.flag_only\n")], ""),
}


@pytest.mark.parametrize("name", sorted(REGISTRY_CORPORA))
def test_registry_fixtures_match_jax(name):
    files, docs = REGISTRY_CORPORA[name]
    files = files + [("fedml_tpu/arguments.py", "_DEFAULTS = {'comm_round': 10}\n")]
    jax_corpus = [jax_engine.ModuleSource.parse(p, textwrap.dedent(s)) for p, s in files]
    port_corpus = [engine.ModuleSource.parse(_port_path(p), textwrap.dedent(s))
                   for p, s in files]
    jax = jax_registry.check_registry(jax_corpus, docs_text=docs)
    port = registry.check_registry(port_corpus, docs_text=docs)
    assert [(_port_path(f.path), f.line, f.rule, f.message) for f in sorted(jax)] == [
        (f.path, f.line, f.rule, f.message) for f in sorted(port)]
    # every corpus but the comparison one has findings
    assert bool(port) == (name != "comparison")


# -- the engine -----------------------------------------------------------------

def test_suppressions_parse_alike():
    src = ("x = 1  # lint: except-ok, host-sync-ok\n"
           "# lint: determinism-ok naming why\n"
           "y = 2\n"
           "z = 3  # lint:thread-lock-ok\n")
    port = engine.ModuleSource.parse("fedml_tpu_torch/a.py", src)
    jax = jax_engine.ModuleSource.parse("fedml_tpu/a.py", src)
    assert port.suppressions == jax.suppressions
    assert port.standalone_suppressions == jax.standalone_suppressions
    for rule in ("except", "host-sync", "determinism", "thread-lock"):
        for line in range(1, 5):
            assert port.is_suppressed(rule, line) == jax.is_suppressed(rule, line)


def _findings(engine_mod, prefix):
    f = engine_mod.Finding
    return [f(f"{prefix}/core/x.py", 3, "except", "m"),
            f(f"{prefix}/core/x.py", 9, "except", "m"),
            f(f"{prefix}/core/y.py", 4, "registry", "other")]


def test_diff_baseline_and_counts_agree():
    port, jax = _findings(engine, "fedml_tpu_torch"), _findings(jax_engine, "fedml_tpu")
    cases = [({}, 0), ({"core/x.py:except:m": 1}, 0), ({"core/x.py:except:m": 3}, 0),
             ({"core/x.py:except:m": 2, "core/y.py:registry:other": 1,
               "core/z.py:except:gone": 1}, 0)]
    for base, _ in cases:
        p_new, p_stale = engine.diff_baseline(
            port, {f"fedml_tpu_torch/{k}": v for k, v in base.items()})
        j_new, j_stale = jax_engine.diff_baseline(
            jax, {f"fedml_tpu/{k}": v for k, v in base.items()})
        assert [(f.line, f.message) for f in p_new] == [(f.line, f.message) for f in j_new]
        assert [k.split("/", 1)[1] for k in p_stale] == [k.split("/", 1)[1] for k in j_stale]
    assert engine.findings_to_counts(port) == {
        f"fedml_tpu_torch/{k.split('/', 1)[1]}": v
        for k, v in jax_engine.findings_to_counts(jax).items()}


def _cli_payload(engine_mod, prefix, baseline_path):
    args = argparse.Namespace(ci=True, no_baseline=False, update_baseline=False, as_json=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = engine_mod.run_ratchet_cli("lint", args, _findings(engine_mod, prefix),
                                        baseline_path, json_extra={"root": "r"})
    return rc, json.loads(out.getvalue().splitlines()[-1])


def test_json_payload_and_gate_agree(tmp_path):
    payloads = []
    for engine_mod, prefix in ((engine, "fedml_tpu_torch"), (jax_engine, "fedml_tpu")):
        path = str(tmp_path / f"{prefix}.json")
        engine_mod.save_baseline(path, _findings(engine_mod, prefix)[:2])
        assert engine_mod.load_baseline(path) == {f"{prefix}/core/x.py:except:m": 2}
        payloads.append(_cli_payload(engine_mod, prefix, path))
    (port_rc, port), (jax_rc, jax) = payloads
    assert port_rc == jax_rc == 1
    assert list(port) == list(jax) == ["ok", "root", "total", "baselined", "new", "stale",
                                      "findings"]
    assert (port["ok"], port["total"], port["baselined"]) == (jax["ok"], jax["total"],
                                                             jax["baselined"])
    strip = lambda fs: [{**f, "path": f["path"].split("/", 1)[1]} for f in fs]  # noqa: E731
    assert strip(port["new"]) == strip(jax["new"])
    assert strip(port["findings"]) == strip(jax["findings"])


def test_rules_leave_out_retrace_and_donation():
    assert set(engine.RULES) == set(jax_engine.RULES) - {"retrace", "donation"}
    with open(os.path.join(REPO, "docs", "static_analysis.md")) as fh:
        catalog = fh.read()
    for rule in engine.RULES:
        assert f"`{rule}`" in catalog
    assert engine.BASELINE_NAME == "lint_baseline_torch.json"


def test_port_series_are_documented_beside_the_package(tmp_path):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "a.md").write_text("`shared_series_total`\n")
    series = tmp_path / engine.PORT_SERIES_DOC
    series.parent.mkdir(parents=True)
    series.write_text("| `port_only_series_total` | counter |\n")
    docs = engine.load_docs_text(str(tmp_path))
    corpus = [engine.ModuleSource.parse("fedml_tpu_torch/core/t.py", textwrap.dedent("""\
        def f(tel):
            tel.inc("shared_series_total")
            tel.inc("port_only_series_total")
            tel.inc("nowhere_series_total")
        """))]
    undocumented = [f.message for f in registry.check_registry(corpus, docs)
                    if "not documented" in f.message]
    assert len(undocumented) == 1 and "nowhere_series_total" in undocumented[0]
    assert not engine.PORT_SERIES_DOC.startswith("docs/")


# -- the torch rules ----------------------------------------------------------------

PORT_HOT = "fedml_tpu_torch/serving/engine.py"


def _port_hits(check, path, src):
    mod = engine.ModuleSource.parse(path, textwrap.dedent(src))
    return [(f.line, f.message.split(" ", 1)[0]) for f in check(mod)
            if not mod.is_suppressed(f.rule, f.line)]


def test_host_sync_flags_the_torch_syncs():
    src = """\
        import numpy as np
        import torch
        class Engine:
            def __init__(self, t):
                self.n = int(t)
                self.host = t.cpu()
            def step(self, t, ev, args):
                a = t.cpu()
                b = t.tolist()
                c = t.detach().numpy()
                d = float(t.sum())
                e = bool(t.any())
                f = np.asarray(t)
                torch.cuda.synchronize()
                ev.synchronize()
                g = torch.asarray(t)
                h = int(args.serve_max_batch)
                k = int(t.shape[0])
                m = t.cpu()  # lint: host-sync-ok
                return a, b, c, d, e, f, g, h, k, m
        """
    assert _port_hits(hostsync.check_host_sync, PORT_HOT, src) == [
        (8, ".cpu()"), (9, ".tolist()"), (10, ".numpy()"), (11, "float()"),
        (12, "bool()"), (13, "np.asarray()"), (14, "torch.cuda.synchronize()"),
        (15, "ev.synchronize()")]
    assert _port_hits(hostsync.check_host_sync, "fedml_tpu_torch/cli.py", src) == []


def test_determinism_flags_the_global_torch_generator():
    src = """\
        import torch
        def sample(n, g):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            a = torch.rand(n)
            b = torch.randperm(n)
            c = torch.randn_like(a)
            d = torch.randperm(n, generator=g)
            e = torch.normal(0.0, 1.0, size=(n,), generator=g)
            h = torch.Generator().manual_seed(3)
            g.manual_seed(1)
            return a, b, c, d, e, h
        """
    path = "fedml_tpu_torch/data/synthetic.py"
    assert [line for line, _ in _port_hits(determinism.check_determinism, path, src)] == [
        3, 4, 5, 6, 7]
    assert _port_hits(determinism.check_determinism, "fedml_tpu_torch/core/telemetry.py",
                      src) == []
    # the relaxed profile (the port's tests) applies it everywhere
    forced = determinism.check_determinism(
        engine.ModuleSource.parse("tests/test_torch_x.py", textwrap.dedent(src)), force=True)
    assert len(forced) == 5


# -- the tree -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    root = engine.find_repo_root(REPO)
    return root, engine.load_corpus(root)


def test_corpus_is_the_port_and_its_tests(corpus):
    root, mods = corpus
    assert root == REPO
    paths = [m.path for m in mods]
    assert all(p.startswith("fedml_tpu_torch/") or p.startswith("tests/") for p in paths)
    assert "fedml_tpu_torch/analysis/engine.py" in paths
    assert "tests/torch_world.py" in paths and "tests/test_torch_lint.py" in paths
    assert not any(p.startswith("tests/test_lint") or p.startswith("fedml_tpu/") for p in paths)


def test_port_lints_clean_against_its_baseline(corpus):
    root, mods = corpus
    findings = engine.run_lint(root, corpus=list(mods))
    baseline = engine.load_baseline(os.path.join(root, engine.BASELINE_NAME))
    new, stale = engine.diff_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], "\n".join(stale)
    # a bare except planted in an in-memory copy is a new finding
    planted = list(mods)
    for i, m in enumerate(planted):
        if m.path == "fedml_tpu_torch/core/losses.py":
            planted[i] = engine.ModuleSource.parse(
                m.path, m.text + "\n\ndef _probe():\n    try:\n        return 1\n"
                                 "    except:\n        pass\n")
    new, _ = engine.diff_baseline(engine.run_lint(root, corpus=planted), baseline)
    assert sorted((f.path, f.rule) for f in new) == [
        ("fedml_tpu_torch/core/losses.py", "except")] * 2


def test_cli_lint_ci_json_exits_zero_at_head(capsys):
    from fedml_tpu_torch import cli

    assert cli.main(["lint", "--ci", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert payload["ok"] is True and payload["new"] == [] and payload["stale"] == []
    assert payload["total"] == payload["baselined"] > 0


def test_analysis_imports_only_the_standard_library():
    """Every import of the analysis planes is the standard library's (or
    the package's own, relative), with one exception, the JAX package's
    own contract (``fedml_tpu/analysis/compiled.py``): ``compiled.py``
    and ``audit.py`` may import torch inside a function body, never at
    module level. ``perf.py`` stays stdlib throughout."""
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    names = sorted(n for n in os.listdir(ANALYSIS) if n.endswith(".py"))
    assert names == ["__init__.py", "audit.py", "compiled.py", "determinism.py", "engine.py",
                     "exceptions.py", "hostsync.py", "perf.py", "registry.py", "threads.py"]
    torch_in_functions = {"audit.py", "compiled.py"}
    for name in names:
        with open(os.path.join(ANALYSIS, name), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        in_function = {id(node) for fn in ast.walk(tree)
                       if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                       for node in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue  # each other
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top == "torch" and name in torch_in_functions:
                    assert id(node) in in_function, f"{name} imports {mod} at module level"
                    continue
                assert top in stdlib, f"{name} imports {mod}"
