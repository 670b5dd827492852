"""Registry conformance audit — the port's plugin contracts as a machine gate.

The plugin contracts (``@register_topology`` cost-hook v2,
``@register_codec``'s full ``WireCodec`` surface, the committed smoke-gate
schema) have so far lived in docstrings: a topology shipping a v1 cost
hook or a codec missing ``decode_range`` only fails when some test
happens to exercise it. ``python -m repro_torch.detlint audit`` imports the
live registries and checks the contracts directly:

* **REG001** — every registered topology declares ``cost_api_version == 2``;
* **REG002** — its ``cost_phase_plan``/``cost_pipelined_plan`` hooks take
  ``codec`` as a *keyword-only* parameter (the v2 signature);
* **REG003** — every registered codec implements the full
  :class:`~repro_torch.core.wire_codec.WireCodec` surface: ``encode``/
  ``decode``/``wire_bytes`` overridden (the base raises), ``decode_range``/
  ``decode_cost_s`` present and callable, ``lossless`` a bool;
* **REG004** — ``benchmarks/expected_smoke.json`` is schema-valid:
  a non-empty flat mapping of ``seg/seg/...`` invariant names to JSON
  scalars (the shape ``repro_torch.smoke`` checks the port against).

Unlike the AST rules this pass imports the package (torch and numpy);
the plain lint stays stdlib-only.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import pathlib
import re
from typing import Mapping

_V2_HOOKS = ("cost_phase_plan", "cost_pipelined_plan")
_CODEC_ABSTRACT = ("encode", "decode", "wire_bytes")
_CODEC_SURFACE = ("encode", "decode", "decode_range", "wire_bytes",
                  "decode_cost_s")
_SMOKE_KEY_RE = re.compile(r"^[a-z0-9_]+(/[A-Za-z0-9_.,+=-]+)+$")
DEFAULT_SMOKE = pathlib.Path("benchmarks") / "expected_smoke.json"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    code: str
    subject: str
    message: str

    def render(self) -> str:
        return f"{self.code} [{self.subject}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _live_topologies() -> Mapping[str, object]:
    # importing repro_torch.core registers the builtins + sharded_tree;
    # geo_tiered registers on its own import
    import repro_torch.core  # noqa: F401
    import repro_torch.core.geo_tiered  # noqa: F401
    from repro_torch.core.topology import _REGISTRY
    return dict(_REGISTRY)


def _live_codecs() -> Mapping[str, object]:
    from repro_torch.core.wire_codec import _REGISTRY
    return dict(_REGISTRY)


def audit_topologies(registry: Mapping[str, object] | None = None
                     ) -> list[Finding]:
    if registry is None:
        registry = _live_topologies()
    findings: list[Finding] = []
    for name in sorted(registry):
        topo = registry[name]
        version = getattr(topo, "cost_api_version", None)
        if version != 2:
            findings.append(Finding(
                "REG001", f"topology:{name}",
                f"cost_api_version is {version!r}, expected 2 — v1 cost "
                f"hooks price raw wire bytes under compressing codecs"))
        for hook in _V2_HOOKS:
            fn = getattr(topo, hook, None)
            if fn is None:
                findings.append(Finding(
                    "REG002", f"topology:{name}",
                    f"missing cost hook {hook!r} (inherit Topology to "
                    f"get the declares-no-model default)"))
                continue
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                findings.append(Finding(
                    "REG002", f"topology:{name}",
                    f"{hook} has no inspectable signature"))
                continue
            codec = params.get("codec")
            if codec is None or codec.kind is not inspect.Parameter.KEYWORD_ONLY:
                findings.append(Finding(
                    "REG002", f"topology:{name}",
                    f"{hook} must take codec= as a keyword-only "
                    f"parameter (cost-hook v2); got "
                    f"{'no codec parameter' if codec is None else str(codec.kind)}"))
    return findings


def audit_codecs(registry: Mapping[str, object] | None = None
                 ) -> list[Finding]:
    from repro_torch.core.wire_codec import WireCodec
    if registry is None:
        registry = _live_codecs()
    findings: list[Finding] = []
    for name in sorted(registry):
        codec = registry[name]
        cls = type(codec)
        for meth in _CODEC_SURFACE:
            if not callable(getattr(codec, meth, None)):
                findings.append(Finding(
                    "REG003", f"codec:{name}",
                    f"missing WireCodec method {meth!r}"))
            elif meth in _CODEC_ABSTRACT and \
                    getattr(cls, meth, None) is getattr(WireCodec, meth):
                findings.append(Finding(
                    "REG003", f"codec:{name}",
                    f"{meth} is WireCodec's raising stub — a registered "
                    f"codec must implement it"))
        if not isinstance(getattr(codec, "lossless", None), bool):
            findings.append(Finding(
                "REG003", f"codec:{name}",
                "lossless must be a bool (drives determinism-grid "
                "expectations)"))
    return findings


def audit_smoke_schema(path: str | pathlib.Path | None = None
                       ) -> list[Finding]:
    path = pathlib.Path(path) if path is not None else DEFAULT_SMOKE
    subject = f"smoke:{path.as_posix()}"
    if not path.exists():
        return [Finding("REG004", subject, "expected-smoke file not found")]
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        return [Finding("REG004", subject, f"not valid JSON: {e}")]
    if not isinstance(data, dict) or not data:
        return [Finding("REG004", subject,
                        "must be a non-empty JSON object of invariants")]
    findings: list[Finding] = []
    for key in sorted(data):
        if not isinstance(key, str) or not _SMOKE_KEY_RE.match(key):
            findings.append(Finding(
                "REG004", subject,
                f"invariant name {key!r} is not slash-segmented "
                f"([a-z0-9_] root, /-separated segments)"))
        value = data[key]
        if not isinstance(value, (bool, int, float, str)):
            findings.append(Finding(
                "REG004", subject,
                f"invariant {key!r} has non-scalar value "
                f"{type(value).__name__} — the gate diffs scalars only"))
    return findings


def run_audit(smoke_path: str | pathlib.Path | None = None) -> list[Finding]:
    """The full conformance audit: topologies + codecs + smoke schema."""
    return sorted(audit_topologies() + audit_codecs()
                  + audit_smoke_schema(smoke_path))
