"""detlint for ``repro_torch``: static enforcement of the port's
determinism contracts.

The dynamic suite proves the invariants hold on the paths it runs;
detlint proves the *bug classes* stay out of every file: unseeded RNG,
numpy's, the stdlib's and torch's default generator and global seeding
(DET001); wall-clock reads in the event-time planes (DET002); env access
outside ``repro_torch.knobs`` (ENV001); order-sensitive accumulation in
the value-plane modules, fused-rounding torch ops, CUDA-atomic scatters
and parallel scans included (ORD001); shared-state mutation in fold-pool
callables (THR001). A registry conformance audit (REG001-REG004)
machine-checks the port's ``@register_topology``/``@register_codec``
plugin contracts and the smoke-gate schema.

The rule codes are those of the JAX package's linter, so one pragma
syntax serves both trees. See :mod:`repro_torch.detlint.engine` for the
pragma syntax and the ``@register_rule`` extension point.
"""

from repro_torch.detlint.audit import run_audit  # noqa: F401
from repro_torch.detlint.engine import (  # noqa: F401
    PARSE_CODE,
    PRAGMA_CODE,
    Rule,
    Violation,
    available_rules,
    get_rules,
    lint_file,
    lint_paths,
    lint_source,
    register_rule,
)
