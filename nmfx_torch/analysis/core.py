"""The port's contract linter, core: findings, the rule registry,
suppressions and baselines (counterpart of ``nmfx/analysis/core.py``).

The port's correctness rests on contracts no crash enforces: a config
field missing from the registry fingerprint resumes a stale registry
silently (``nmfx_torch/registry.py``), one missing from the result-cache
key serves a finished result to another configuration, a fault site with
no flight-recorder category fires unseen, and a lock taken in two orders
deadlocks only under load. Each rule (``nmfx_torch/analysis/rules_*.py``
and ``concurrency/``) encodes one of these classes; this module is the
machinery they share.

Suppression syntax, on the offending line (the reference's)::

    something_flagged()  # nmfx: ignore[NMFX006] -- why this is safe

The rule id list is comma-separated; the ``-- reason`` is required (a
suppression without one is itself a finding, ``NMFX000``, and suppresses
nothing).

Baselines are JSON lists of ``{file, rule, line}`` records
(``--baseline FILE``): findings matching a record are reported as
baselined and do not fail the run. The port's tree is held clean with an
empty baseline.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Iterable

#: severity levels: only "error" findings fail the run (exit code /
#: test assertion); "warning" is advisory output
SEVERITIES = ("error", "warning")

#: suppression comment: ``# nmfx: ignore[ID1, ID2] -- reason``
_SUPPRESS_RE = re.compile(
    r"#\s*nmfx:\s*ignore\[(?P<ids>[A-Za-z0-9_,\s]*)\]"
    r"(?:\s*--\s*(?P<reason>.*\S))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to ``file:line``."""

    file: str
    line: int
    rule_id: str
    message: str
    severity: str = "error"
    col: int = 0
    #: set by the suppression/baseline pass, not by rules
    suppressed: bool = False
    baselined: bool = False

    def render(self) -> str:
        tag = ("" if not (self.suppressed or self.baselined)
               else (" [suppressed]" if self.suppressed else " [baselined]"))
        return (f"{self.file}:{self.line}: {self.rule_id} "
                f"{self.severity}: {self.message}{tag}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base class: one contract class per rule.

    ``check(project)`` yields Findings over a :class:`Project`
    (``nmfx_torch.analysis.ast_scan``). Cross-file rules (NMFX001's
    config/fingerprint cross-reference) see the whole
    project; per-file rules iterate ``project.modules``.
    """

    rule_id: str = "NMFX000"
    title: str = ""
    #: default severity for this rule's findings
    severity: str = "error"

    def check(self, project) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, file: str, line: int, message: str,
                severity: "str | None" = None, col: int = 0) -> Finding:
        return Finding(file=file, line=line, rule_id=self.rule_id,
                       message=message, col=col,
                       severity=severity or self.severity)


#: rule_id -> Rule instance. Population happens at import of
#: ``nmfx_torch.analysis`` (each rules_* module registers its rules); the
#: registry is ordered by registration so output is deterministic.
RULES: "dict[str, Rule]" = {}


def register(rule: "Rule | Callable[[], Rule]") -> Rule:
    """Register a rule instance (or zero-arg factory). Usable as a class
    decorator: ``@register`` on a Rule subclass registers an instance."""
    inst = rule() if isinstance(rule, type) else rule
    if inst.rule_id in RULES:
        raise ValueError(f"duplicate rule id {inst.rule_id}")
    RULES[inst.rule_id] = inst
    return rule


def _comment_tokens(path: str, text: str):
    """(lineno, comment_text) for every COMMENT token — suppression
    syntax quoted inside a string literal or docstring must neither
    suppress nor trip NMFX000. Falls back to whole lines on tokenize
    errors (a file broken enough to fail tokenize fails ast.parse too,
    so this path only covers encoding oddities)."""
    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for lineno, line in enumerate(text.splitlines(), start=1):
            yield lineno, line


def parse_suppressions(path: str, text: str):
    """``line -> set of suppressed rule ids`` for one source file, plus
    NMFX000 findings for malformed suppressions (missing reason or empty
    id list — those do NOT suppress anything)."""
    by_line: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for lineno, line in _comment_tokens(path, text):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in m.group("ids").split(",") if s.strip()}
        reason = m.group("reason")
        if not ids or not reason:
            bad.append(Finding(
                file=path, line=lineno, rule_id="NMFX000",
                message=("malformed suppression: use '# nmfx: "
                         "ignore[RULE-ID] -- reason' (the reason is "
                         "required; this comment suppresses nothing)"),
                severity="error"))
            continue
        by_line.setdefault(lineno, set()).update(ids)
    return by_line, bad


def load_baseline(path: "str | None") -> "list[dict]":
    if path is None:
        return []
    with open(path) as f:
        records = json.load(f)
    if not isinstance(records, list):
        raise ValueError(f"baseline {path!r} must be a JSON list of "
                         "{file, rule, line} records")
    return records


def apply_baseline(findings: "list[Finding]",
                   baseline: "list[dict]") -> "list[Finding]":
    """Mark findings matching a baseline record. Matching is by
    (file, rule, line) — a moved finding resurfaces, which is the
    point: baselines tolerate known debt, not a file's whole future.
    File paths normalize to absolute before comparing, so a baseline
    written from a relative invocation still applies to an
    absolute-path run (and vice versa) as long as the cwd is the same
    project root."""
    import os

    keys = {(os.path.abspath(str(r.get("file"))), r.get("rule"),
             r.get("line"))
            for r in baseline}
    return [dataclasses.replace(f, baselined=True)
            if (os.path.abspath(f.file), f.rule_id, f.line) in keys
            else f
            for f in findings]


def active(findings: "Iterable[Finding]",
           severity: str = "error") -> "list[Finding]":
    """The findings that fail a run: given severity, not suppressed,
    not baselined."""
    return [f for f in findings
            if f.severity == severity
            and not f.suppressed and not f.baselined]
