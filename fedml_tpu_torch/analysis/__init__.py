"""``fedml_tpu_torch.analysis``: the port's analysis planes (port of
``fedml_tpu/analysis/``), three of them, each behind a subcommand of
``python -m fedml_tpu_torch.cli``:

- ``lint`` (``engine.py`` and one module a checker): the static-analysis
  suite over the source (the rule catalog is
  ``docs/static_analysis.md``), ratcheted against
  ``lint_baseline_torch.json``. Rule ids:

  - ``host-sync``    hidden device->host syncs (``.item()``, ``.cpu()``,
                     ``float(t)``, ``torch.cuda.synchronize``, ...) on
                     round/serving hot paths
  - ``determinism``  global NumPy/stdlib/torch RNG and wall clocks in
                     seeded paths (+ the port's tests, relaxed profile)
  - ``except``       bare excepts and swallow-without-log/counter
  - ``thread-lock``  cross-thread attribute access without the owning lock
  - ``registry``     MSG_TYPE/telemetry/knob registries vs their docs+schema

  The JAX rules ``retrace`` and ``donation`` have no PyTorch meaning and
  are left out.
- ``audit`` (``compiled.py``, ``audit.py``): every registered hot
  executable traced once on fake tensors (nothing executes), checked for
  host transfers, the pow2 shape census and host constants, ratcheted
  against ``audit_baseline_torch.json``; its static cost goes to
  ``audit_report_torch.json``. The JAX rule ``aot-donation`` is left out.
- ``perf`` (``perf.py``): measured seconds joined to the audit's FLOPs,
  the idle-time ledger of the cross-silo rounds, and the ``BENCH_*.json``
  ratchet.

Importing this package imports no torch, NumPy or YAML: ``lint`` and
``perf`` are pure stdlib, and ``compiled.py`` and ``audit.py`` import
torch only inside their functions, so the gates run on a bare checkout.
"""

from .engine import (  # noqa: F401
    BASELINE_NAME,
    Finding,
    ModuleSource,
    RULES,
    diff_baseline,
    find_repo_root,
    findings_to_counts,
    load_baseline,
    load_corpus,
    main,
    run_lint,
    save_baseline,
)
