"""Rule ``registry`` — consistency between the port's three
registries and their sources of truth (port of
``fedml_tpu/analysis/registry.py``, meaning kept).

1. **MSG_TYPE coverage** — every ``MSG_TYPE_*`` constant in
   ``constants.py`` must be *dispatchable*: registered via
   ``register_message_receive_handler`` somewhere, or consumed at the
   comm layer (a ``==`` / ``in`` comparison — the reliable channel's
   ACK path). An orphaned message type is a protocol message nothing
   can receive.

2. **Telemetry naming + documentation** — every series name emitted
   through ``.inc`` / ``.set_gauge`` / ``.observe`` must (a) follow
   the convention — counters end ``_total``; histograms carry a unit
   suffix (``_seconds``/``_s``/``_ms``/``_bytes``/``_frac`` or
   ``_total``); gauges must NOT end ``_total`` (Prometheus reserves
   it for counters) — and (b) appear in the docs counters tables
   (``docs/*.md``, read and never edited, since the port emits the JAX
   package's names; a series only the port emits is documented in
   ``fedml_tpu_torch/analysis/series.md``): an undocumented counter is
   invisible to the invariant checker's operators and to dashboards.

3. **Knob coverage** — every ``args.<knob>`` read (attribute access
   or ``getattr(args, "<knob>")``) must have an entry in
   ``fedml_tpu_torch/arguments.py``'s ``_DEFAULTS`` schema (which doubles as the
   validation table) or be a recognised runtime attribute (rank,
   role, process identity — set by ``init()``/launchers, not
   configuration). A knob read without a schema entry is exactly the
   "no typed schema, no validation" reference bug the Arguments layer
   exists to fix.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import Finding, ModuleSource

RULE = "registry"

# runtime attributes assigned by init()/launchers/tests rather than
# declared configuration — reads of these are not knob reads
RUNTIME_ARGS = {
    "rank", "local_rank", "role", "run_id", "process_id",
    "yaml_config_file", "worker_num", "client_rank", "client_id",
    "device", "verbose", "distributed_coordinator", "proc_rank_in_silo",
    "rank_in_node", "node_rank", "n_proc_in_silo", "silo_rank", "comm",
}

# unit vocabulary for histogram names; "_rounds" is a federation-native
# unit (staleness, probation length) just like seconds or bytes, and
# "_ratio" is the dimensionless quotient that may exceed 1 (anomaly
# scores) where "_frac" promises [0, 1]
_HISTOGRAM_SUFFIXES = (
    "_seconds", "_s", "_ms", "_bytes", "_frac", "_ratio", "_rounds",
    "_total",
)

_EMIT_METHODS = {"inc": "counter", "set_gauge": "gauge", "observe": "histogram"}

# unit-suffix near-misses: abbreviations and synonyms of the canonical
# vocabulary that read fine in review but split dashboards into two
# series families ("wire_utilization_fraction" next to "_frac")
_UNIT_NEAR_MISSES = (
    "_sec", "_secs", "_second", "_millis", "_msec", "_fraction",
    "_percent", "_pct", "_byte", "_count",
)

# Arguments methods — `args.get(...)` et al. are API calls, not knob
# attribute reads (the .get STRING key is collected separately)
_ARGS_METHODS = {
    "get", "to_dict", "load_yaml_config", "set_attr_from_config",
}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def collect_msg_types(constants_mod: ModuleSource) -> List[Tuple[str, int]]:
    out = []
    for node in ast.walk(constants_mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id.startswith("MSG_TYPE_"):
                out.append((t.id, node.lineno))
    return out


def _msg_type_consumers(corpus: Iterable[ModuleSource]) -> Set[str]:
    """MSG_TYPE_* names that are registered to a handler or consumed
    in a comparison/membership test somewhere in the corpus."""
    consumed: Set[str] = set()

    def names_in(node: ast.AST) -> Set[str]:
        found = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr.startswith(
                "MSG_TYPE_"
            ):
                found.add(sub.attr)
            elif isinstance(sub, ast.Name) and sub.id.startswith("MSG_TYPE_"):
                found.add(sub.id)
        return found

    for mod in corpus:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                callee = (
                    fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None
                )
                if callee == "register_message_receive_handler" and node.args:
                    consumed |= names_in(node.args[0])
            elif isinstance(node, ast.Compare):
                consumed |= names_in(node)
            elif isinstance(node, ast.Dict):
                # handler tables keyed by msg type
                for k in node.keys:
                    if k is not None:
                        consumed |= names_in(k)
    return consumed


def collect_telemetry_emissions(
    corpus: Iterable[ModuleSource],
) -> List[Tuple[str, str, str, int]]:
    """(kind, name, path, line) for every literal-named emission."""
    out = []
    for mod in corpus:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            kind = _EMIT_METHODS.get(fn.attr)
            if kind is None or not node.args:
                continue
            name = _const_str(node.args[0])
            if name is None:
                continue  # variable-named series are the caller's job
            out.append((kind, name, mod.path, node.lineno))
    return out


def collect_defaults_keys(arguments_mod: ModuleSource) -> Set[str]:
    """Keys of the module-level ``_DEFAULTS`` dict literal — the knob
    schema the validation layer is built over."""
    keys: Set[str] = set()
    for node in arguments_mod.tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        if "_DEFAULTS" not in names:
            continue
        value = node.value
        if isinstance(value, ast.Dict):
            for k in value.keys:
                s = _const_str(k) if k is not None else None
                if s:
                    keys.add(s)
    return keys


# modules whose local `args` is an argparse CLI namespace, not the
# federation Arguments schema — their attribute reads are flag reads
_ARGPARSE_MODULES = ("fedml_tpu_torch/cli.py", "fedml_tpu_torch/edge_agent.py")
_ARGPARSE_PREFIXES = ("fedml_tpu_torch/analysis/",)


def _is_argparse_module(path: str) -> bool:
    return path in _ARGPARSE_MODULES or path.startswith(_ARGPARSE_PREFIXES)


def collect_knob_reads(
    corpus: Iterable[ModuleSource],
) -> List[Tuple[str, str, int]]:
    """(knob, path, line) for every ``args.<k>`` / ``self.args.<k>``
    attribute read and every ``getattr(<args-ish>, "<k>"[, default])``.
    Argparse-namespace modules (the CLIs and this analysis package)
    are exempt — their ``args`` is not the federation schema."""
    out = []
    for mod in corpus:
        if _is_argparse_module(mod.path):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                v = node.value
                is_args = (
                    (isinstance(v, ast.Name) and v.id == "args")
                    or (isinstance(v, ast.Attribute) and v.attr == "args")
                )
                if (
                    is_args
                    and not node.attr.startswith("_")
                    and node.attr not in _ARGS_METHODS
                ):
                    out.append((node.attr, mod.path, node.lineno))
            elif isinstance(node, ast.Call):
                fn = node.func
                is_getattr = isinstance(fn, ast.Name) and fn.id == "getattr"
                is_args_get = (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "get"
                    and (
                        (isinstance(fn.value, ast.Name)
                         and fn.value.id == "args")
                        or (isinstance(fn.value, ast.Attribute)
                            and fn.value.attr == "args")
                    )
                )
                if is_args_get and node.args:
                    key = _const_str(node.args[0])
                    if key and not key.startswith("_"):
                        out.append((key, mod.path, node.lineno))
                    continue
                if not is_getattr or len(node.args) < 2:
                    continue
                tgt, key = node.args[0], _const_str(node.args[1])
                if key is None or key.startswith("_"):
                    continue
                is_args = (
                    (isinstance(tgt, ast.Name) and tgt.id == "args")
                    or (isinstance(tgt, ast.Attribute) and tgt.attr == "args")
                )
                if is_args:
                    out.append((key, mod.path, node.lineno))
    return out


def _assigned_args_attrs(corpus: Iterable[ModuleSource]) -> Set[str]:
    """Attributes the codebase *assigns* onto an args object
    (``args.X = ...`` / ``setattr(args, "X", ...)``) — runtime state,
    not configuration, so reads of them are covered."""
    out: Set[str] = set()
    for mod in corpus:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Store
            ):
                v = node.value
                if (isinstance(v, ast.Name) and v.id == "args") or (
                    isinstance(v, ast.Attribute) and v.attr == "args"
                ):
                    out.add(node.attr)
            elif isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Name)
                    and fn.id == "setattr"
                    and len(node.args) >= 3
                ):
                    tgt, key = node.args[0], _const_str(node.args[1])
                    if key and (
                        (isinstance(tgt, ast.Name) and tgt.id == "args")
                        or (isinstance(tgt, ast.Attribute)
                            and tgt.attr == "args")
                    ):
                        out.add(key)
    return out


def check_registry(
    corpus: List[ModuleSource],
    docs_text: str,
    constants_path: str = "fedml_tpu_torch/constants.py",
    arguments_path: str = "fedml_tpu_torch/arguments.py",
    runtime_args: Optional[Set[str]] = None,
) -> List[Finding]:
    findings: List[Finding] = []
    by_path = {m.path: m for m in corpus}
    runtime = RUNTIME_ARGS if runtime_args is None else runtime_args

    # 1) MSG_TYPE coverage
    constants_mod = by_path.get(constants_path)
    if constants_mod is not None:
        consumed = _msg_type_consumers(corpus)
        for name, line in collect_msg_types(constants_mod):
            if name not in consumed:
                findings.append(Finding(
                    path=constants_path, line=line, rule=RULE,
                    message=(
                        f"{name} has no handler registration and no "
                        "comm-layer dispatch — an orphaned protocol "
                        "message nothing can receive"
                    ),
                ))

    # 2) telemetry naming + documentation
    documented = set(re.findall(r"[a-z][a-z0-9_]{2,}", docs_text))
    seen_names: Set[Tuple[str, str]] = set()
    for kind, name, path, line in collect_telemetry_emissions(corpus):
        if kind == "counter" and not name.endswith("_total"):
            findings.append(Finding(
                path=path, line=line, rule=RULE,
                message=(
                    f"counter '{name}' does not end in _total (the "
                    "Prometheus counter convention every dashboard "
                    "and the invariant checker key on)"
                ),
            ))
        elif kind == "gauge" and name.endswith("_total"):
            findings.append(Finding(
                path=path, line=line, rule=RULE,
                message=(
                    f"gauge '{name}' ends in _total — Prometheus "
                    "reserves _total for counters; rename the gauge"
                ),
            ))
        elif kind in ("gauge", "histogram") and name.endswith(
            _UNIT_NEAR_MISSES
        ):
            findings.append(Finding(
                path=path, line=line, rule=RULE,
                message=(
                    f"{kind} '{name}' ends in a unit-suffix near-miss "
                    "— use the canonical vocabulary "
                    "(_seconds/_s/_ms/_bytes/_frac/_ratio/_rounds) so "
                    "one quantity stays one series family"
                ),
            ))
        elif kind == "histogram" and not name.endswith(_HISTOGRAM_SUFFIXES):
            findings.append(Finding(
                path=path, line=line, rule=RULE,
                message=(
                    f"histogram '{name}' has no unit suffix "
                    "(_seconds/_s/_ms/_bytes/_frac/_ratio/_rounds) — "
                    "unitless series are unreadable on dashboards"
                ),
            ))
        if (kind, name) not in seen_names:
            seen_names.add((kind, name))
            if name not in documented:
                findings.append(Finding(
                    path=path, line=line, rule=RULE,
                    message=(
                        f"telemetry series '{name}' is not documented "
                        "in any docs/ counters table "
                        "(docs/observability.md is the catalog)"
                    ),
                ))

    # 3) knob coverage
    arguments_mod = by_path.get(arguments_path)
    if arguments_mod is not None:
        defaults = collect_defaults_keys(arguments_mod)
        assigned = _assigned_args_attrs(corpus)
        reported: Set[Tuple[str, str, int]] = set()
        for knob, path, line in collect_knob_reads(corpus):
            if path == arguments_path:
                continue  # the schema/validation layer reads itself
            if knob in defaults or knob in runtime or knob in assigned:
                continue
            site = (knob, path, line)
            if site in reported:
                continue
            reported.add(site)
            findings.append(Finding(
                path=path, line=line, rule=RULE,
                message=(
                    f"args.{knob} is read but has no entry in "
                    "arguments.py _DEFAULTS — undeclared knobs skip "
                    "type coercion and validation"
                ),
            ))
    return findings
