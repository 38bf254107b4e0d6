"""``fedml_tpu_torch.analysis`` — the port's static-analysis suite
behind ``python -m fedml_tpu_torch.cli lint`` (port of the ``lint``
half of ``fedml_tpu/analysis/``; the rule catalog is
``docs/static_analysis.md``).

Pure stdlib: importing this package must never import torch, NumPy or
YAML — the gate runs the whole AST pass in seconds on a bare checkout.
Rule ids (one checker each):

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
