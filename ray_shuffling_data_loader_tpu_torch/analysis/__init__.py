"""The port's per-file static checker: project invariants over the
port's own tree.

Run ``python -m ray_shuffling_data_loader_tpu_torch.analysis <paths>``;
``--list-rules`` prints the rule set (the JAX package's per-file rules,
with the Torch rules ``torch-host-sync`` and ``cuda-device-implicit``
in place of its JAX rules). ``# rsdl-lint: disable=<rule>`` on a line
(or a comment line just above it) suppresses a finding there; give the
reason beside it. Stdlib-only: it needs neither torch nor a card.
"""

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Config, Rule, Violation, all_rules, check_paths, check_source)

__all__ = [
    "Config", "Rule", "Violation", "all_rules", "check_paths",
    "check_source",
]
