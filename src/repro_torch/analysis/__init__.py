"""The port's lint (counterpart of ``repro.analysis``): a stdlib-``ast``
lint of ``src/repro_torch`` (rules R1, R2, R4, R5, call-graph aware), run
with ``python -m repro_torch.analysis``. It imports no torch."""
from repro_torch.analysis.findings import (Finding, Report, RULE_KEYS,
                                           format_table, load_baseline)
from repro_torch.analysis.lint import ALL_RULES, run_lint

__all__ = ["Finding", "Report", "RULE_KEYS", "ALL_RULES",
           "run_lint", "format_table", "load_baseline"]
