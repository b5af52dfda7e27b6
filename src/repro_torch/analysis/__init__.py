"""Privacy-egress analysis: static taint linter + runtime wire guard.

The JAX package's ``repro.analysis`` carried over to the port (it imports
neither JAX nor torch there; the port keeps its own copy all the same).

Static side: ``python -m repro_torch.analysis`` (or ``run_analysis(...)``)
walks ``src/repro_torch/**`` and proves raw party data
(`PartyBlock.x/.ids/.y`, streaming scans) cannot reach a wire sink
unsanitized, plus companion rules for bare asserts, determinism, and lock
discipline.  Policy lives in :mod:`repro_torch.analysis.policy`.

Runtime side: :mod:`repro_torch.analysis.runtime` tags raw arrays at
construction and `transport.Channel.send` refuses to ship them, or a
tensor over them (`PrivacyViolationError`), enabled by
``REPRO_EGRESS_GUARD=1``.

This ``__init__`` stays import-light on purpose — the transport layer
imports the runtime guard from every worker process.
"""
from .base import Finding
from .runtime import (PrivacyViolationError, allow_egress, check_egress,
                      taint, taint_block)

__all__ = ["Finding", "PrivacyViolationError", "allow_egress",
           "check_egress", "taint", "taint_block", "run_analysis"]

ALL_RULES = ("egress", "asserts", "determinism", "locks")


def run_analysis(paths, rules=ALL_RULES, policy=None) -> list[Finding]:
    """Run the selected rule passes over ``paths`` (dirs or files) and
    return suppression-filtered findings, sorted by (path, line)."""
    from . import base, egress
    from .policy import DEFAULT_POLICY
    from .rules import asserts, determinism, locks

    policy = policy or DEFAULT_POLICY
    modules = base.load_modules(paths, exclude_globs=policy.exclude_globs)
    findings: list[Finding] = []
    if "egress" in rules:
        findings += egress.run_egress(modules, policy)
    if "asserts" in rules:
        findings += asserts.run(modules, policy)
    if "determinism" in rules:
        findings += determinism.run(modules, policy)
    if "locks" in rules:
        findings += locks.run(modules, policy)
    return base.apply_suppressions(findings, modules)
