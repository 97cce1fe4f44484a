"""tidb_tpu_torch.lint — the package's static-analysis subsystem.

One engine, one parse, one suppression syntax (see engine.py). Run it:

    python -m tidb_tpu_torch.lint        # CI front end, exit 1 on findings
    python -m tidb_tpu_torch.lint --list-rules
    python -m tidb_tpu_torch.lint --rule lock-discipline

or through the pytest shim tests/test_torch_lint.py (one shared parse for
the whole rule set). Rules live in tidb_tpu_torch/lint/rules/; the JAX
package's docs/LINTS.md has the suppression syntax and the
how-to-add-a-rule recipe, which the port keeps; `--list-rules` prints
the port's catalog.
"""

from tidb_tpu_torch.lint import rules as _rules  # noqa: F401 (registers)
from tidb_tpu_torch.lint.engine import (Finding, Forest, REGISTRY, Report,
                                  Rule, register_rule, run, selfcheck)

__all__ = ["Finding", "Forest", "REGISTRY", "Report", "Rule",
           "register_rule", "run", "selfcheck"]
