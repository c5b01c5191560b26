"""NMFX001 — config-key coverage; NMFX007 — checkpoint-manifest
coverage; NMFX011 — result-cache key coverage (counterparts of
``nmfx/analysis/rules_config.py``).

The silent-corruption class these rules kill: a numerics-affecting
``SolverConfig`` / ``ExperimentalConfig`` field that never reaches the
registry fingerprint (``nmfx_torch/registry.py``) lets a registry
written under one configuration resume under another — plausible
factors, wrong numbers, no crash. The same field missing from the
exec-cache bucket key (``nmfx_torch/exec_cache.py``) serves one built
sweep to two configurations; missing from the autotune key
(``nmfx_torch/autotune.py``) it serves a schedule tuned under one value
to another; missing from the checkpoint manifest or the result-cache key
it resumes a stale ledger or replays a finished result for another
configuration.

The rules cross-reference the declarations (introspection hooks, no
hash-body parsing): ``dataclasses.fields`` of the configs (what exists);
``registry.FINGERPRINT_SOLVER_EXCLUDED`` / ``_RESOLVED`` and
``fingerprint_solver_fields``; ``SolverConfig.NON_NUMERICS_FIELDS`` (the
only legitimate exclusions); ``exec_cache.solver_key_fields`` /
``persist_key_fields``; ``data_cache.data_key_fields``;
``serve.serve_key_fields``; ``autotune.autotune_key_fields`` against the
declared tunables; ``checkpoint.manifest_key_fields`` against
``ConsensusConfig.CHECKPOINT_EXEMPT_FIELDS``; and
``result_cache.cache_key_fields`` against
``ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS``. Each check is a pure
function over field sets (``check_config_coverage``,
``check_manifest_coverage``, ``check_result_cache_coverage``) so tests
can inject a changed universe; the rules read the live modules, and run
only when the analyzed tree is the package the import machinery
resolves.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Iterable

from nmfx_torch.analysis.core import Finding, Rule, register


def _decl_site(obj, fallback_file: str) -> "tuple[str, int]":
    """file:line of a class/module-level declaration, best effort."""
    try:
        f = inspect.getsourcefile(obj) or fallback_file
        _, line = inspect.getsourcelines(obj)
        return f, line
    except (OSError, TypeError):
        return fallback_file, 1


def check_config_coverage(
    solver_fields: "frozenset[str]",
    experimental_fields: "frozenset[str]",
    fingerprint_covered: "frozenset[str]",
    fingerprint_excluded: "tuple[str, ...]",
    declared_non_numerics: "tuple[str, ...]",
    exec_key_covered: "frozenset[str]",
    hashable_configs: "dict[str, bool]",
    fingerprint_resolved: "tuple[str, ...]" = (),
    noncompare_fields: "dict[str, tuple[str, ...]]" = {},
    persist_key_covered: "frozenset[str] | None" = None,
    nonrepr_fields: "dict[str, tuple[str, ...]]" = {},
    data_fields: "frozenset[str] | None" = None,
    data_key_covered: "frozenset[str] | None" = None,
    serve_fields: "frozenset[str] | None" = None,
    serve_key_covered: "frozenset[str] | None" = None,
    autotune_solver_covered: "frozenset[str] | None" = None,
    autotune_experimental_covered: "frozenset[str] | None" = None,
    autotune_exempt_solver: "tuple[str, ...]" = (),
    autotune_exempt_experimental: "tuple[str, ...]" = (),
) -> "list[str]":
    """The pure contract check; returns human-readable problems.

    Parameters default to nothing — the Rule wrapper reads the live
    modules; tests inject mutated universes (a field dropped from
    ``fingerprint_covered``, an exclusion not declared) and assert the
    corresponding message appears.
    """
    problems: "list[str]" = []
    # 1. declarations must not go stale
    for name in declared_non_numerics:
        if name not in solver_fields:
            problems.append(
                f"SolverConfig.NON_NUMERICS_FIELDS names {name!r}, which "
                "is not a SolverConfig field — stale declaration")
    for name in fingerprint_resolved:
        if name not in solver_fields:
            problems.append(
                f"registry.FINGERPRINT_SOLVER_RESOLVED names {name!r}, "
                "which is not a SolverConfig field — stale declaration")
    # 2. every fingerprint exclusion must be a declared non-numerics
    #    field (numerics-affecting fields may NEVER be excluded)
    for name in fingerprint_excluded:
        if name not in declared_non_numerics:
            problems.append(
                f"SolverConfig.{name} is excluded from the registry "
                "fingerprint (registry.FINGERPRINT_SOLVER_EXCLUDED) but "
                "not declared execution-strategy-only in "
                "SolverConfig.NON_NUMERICS_FIELDS — a numerics-affecting "
                "field excluded from the fingerprint resumes stale "
                "checkpoints silently")
    # 3. every field must reach the fingerprint unless declared
    for name in sorted(solver_fields - fingerprint_covered):
        if name not in declared_non_numerics:
            problems.append(
                f"SolverConfig.{name} does not reach the registry "
                "fingerprint and is not declared in NON_NUMERICS_FIELDS "
                "— checkpoints written under different values of it "
                "would be served interchangeably")
    # 4. the exec-cache bucket key must cover every field that can
    #    change the compiled program (everything; even declared
    #    non-numerics fields like restart_chunk change program
    #    STRUCTURE, so nothing may be missing here)
    for name in sorted(solver_fields - exec_key_covered):
        problems.append(
            f"SolverConfig.{name} is not covered by the exec-cache "
            "bucket key (exec_cache.solver_key_fields) — two configs "
            "differing in it would share one compiled executable")
    # 4b. the PERSISTENT disk key must cover the same universe: it is
    #     derived from the key's repr (field.repr), so a repr=False
    #     field survives the in-memory key but drops out of the disk
    #     key — a fresh process would deserialize the wrong executable
    if persist_key_covered is not None:
        for name in sorted(solver_fields - persist_key_covered):
            problems.append(
                f"SolverConfig.{name} is not covered by the persistent "
                "exec-cache disk key (exec_cache.persist_key_fields) — "
                "disk entries written under different values of it would "
                "be served interchangeably across processes")
    # 5. the nested experimental knobs ride along via the
    #    'experimental' field; it must itself be covered on both sides
    if experimental_fields and "experimental" not in fingerprint_covered:
        problems.append(
            "SolverConfig.experimental (the ExperimentalConfig knobs) "
            "does not reach the registry fingerprint — every "
            f"experimental field ({', '.join(sorted(experimental_fields))}) "
            "is numerics-affecting by definition")
    # 6. both config dataclasses must stay frozen-with-hash: the bucket
    #    key and jit static-argnames hash the VALUES
    for cls_name, ok in hashable_configs.items():
        if not ok:
            problems.append(
                f"{cls_name} is not a frozen/hashable dataclass — the "
                "exec-cache bucket key and jit static-argument caching "
                "hash config values; an unhashable config breaks both")
    # 7. no field anywhere in the config tree may opt out of comparison:
    #    dataclass __eq__/__hash__ skip compare=False fields, so two
    #    configs differing there would hash equal and share one cached
    #    executable — including fields of the NESTED ExperimentalConfig,
    #    which ride into the bucket key through SolverConfig's hash
    for cls_name, names in noncompare_fields.items():
        for name in names:
            problems.append(
                f"{cls_name}.{name} is declared compare=False — it is "
                "invisible to dataclass __eq__/__hash__ and therefore "
                "to the exec-cache bucket key and jit static-argument "
                "caching; two configs differing in it would share one "
                "compiled executable")
    # 8. ...and none may opt out of REPR either: the persistent disk key
    #    is the key's repr, and dataclass __repr__ elides repr=False
    #    fields — including fields of the NESTED ExperimentalConfig,
    #    which the SolverConfig-level persist_key_fields hook cannot
    #    see. Such a field would stay in the in-memory key (hash/eq)
    #    but vanish from the disk key, so a fresh process would
    #    deserialize the wrong executable.
    for cls_name, names in nonrepr_fields.items():
        for name in names:
            problems.append(
                f"{cls_name}.{name} is declared repr=False — it is "
                "invisible to the repr-derived persistent exec-cache "
                "disk key (exec_cache.persist_key_fields); disk entries "
                "written under different values of it would be served "
                "interchangeably across processes")
    # 9. the device-resident input cache's DataKey must compare on
    #    every field it declares: the cache looks entries up by the
    #    key's dataclass hash/eq, so a compare=False field would alias
    #    two (matrix, placement) pairs onto one cached device buffer —
    #    the data-plane twin of the executable-key hazards above
    if data_fields is not None and data_key_covered is not None:
        for name in sorted(data_fields - data_key_covered):
            problems.append(
                f"DataKey.{name} is not covered by the device-resident "
                "input-cache key (data_cache.data_key_fields) — two "
                "placements differing in it would share one cached "
                "device buffer")
    # 10. the serving front-end's ServeConfig must compare on every
    #     field: serving policies are compared/keyed by dataclass
    #     eq/hash (bench traffic stage, comparable-server tests), so a
    #     compare=False field would alias two different admission/
    #     packing/deadline policies onto one
    if serve_fields is not None and serve_key_covered is not None:
        for name in sorted(serve_fields - serve_key_covered):
            problems.append(
                f"ServeConfig.{name} is not covered by the serving-"
                "policy fingerprint (serve.serve_key_fields) — two "
                "serving policies differing in it would compare equal")
    # 11. the block-shape autotune store's key must cover every config
    #     field that is not a DECLARED tunable: a tunable is what the
    #     stored entry decides (so it must be normalized out of the
    #     key), while any other field outside the key would serve one
    #     tuned shape to two configs whose kernels compile — and time —
    #     differently (a silent performance downgrade, or a tuned
    #     check_block the scheduler rejects under the other config)
    if autotune_solver_covered is not None:
        for name in autotune_exempt_solver:
            if name not in solver_fields:
                problems.append(
                    "autotune.AUTOTUNE_EXEMPT_SOLVER names "
                    f"{name!r}, which is not a SolverConfig field — "
                    "stale declaration")
        for name in sorted(solver_fields - autotune_solver_covered):
            if name not in autotune_exempt_solver:
                problems.append(
                    f"SolverConfig.{name} neither reaches the autotune "
                    "store key (autotune.autotune_key_fields) nor is "
                    "declared tunable in AUTOTUNE_EXEMPT_SOLVER — a "
                    "shape tuned under one value would be served to "
                    "the other")
        for name in autotune_exempt_solver:
            if name in autotune_solver_covered:
                problems.append(
                    f"SolverConfig.{name} is declared tunable in "
                    "AUTOTUNE_EXEMPT_SOLVER but still reaches the "
                    "autotune key — the entry could never be applied "
                    "to the field it claims to decide; drop one "
                    "declaration")
    if autotune_experimental_covered is not None:
        for name in autotune_exempt_experimental:
            if name not in experimental_fields:
                problems.append(
                    "autotune.AUTOTUNE_EXEMPT_EXPERIMENTAL names "
                    f"{name!r}, which is not an ExperimentalConfig "
                    "field — stale declaration")
        for name in sorted(
                experimental_fields - autotune_experimental_covered):
            if name not in autotune_exempt_experimental:
                problems.append(
                    f"ExperimentalConfig.{name} neither reaches the "
                    "autotune store key (autotune.autotune_key_fields) "
                    "nor is declared tunable in "
                    "AUTOTUNE_EXEMPT_EXPERIMENTAL — a shape tuned "
                    "under one value would be served to the other")
        for name in autotune_exempt_experimental:
            if name in autotune_experimental_covered:
                problems.append(
                    f"ExperimentalConfig.{name} is declared tunable in "
                    "AUTOTUNE_EXEMPT_EXPERIMENTAL but still reaches "
                    "the autotune key — the entry could never be "
                    "applied to the field it claims to decide; drop "
                    "one declaration")
    return problems


def _live_universe():
    from nmfx_torch import autotune, data_cache, exec_cache, registry, serve
    from nmfx_torch.config import ExperimentalConfig, SolverConfig

    def _hashable(cls) -> bool:
        return (dataclasses.is_dataclass(cls)
                and cls.__hash__ is not None
                and cls.__dataclass_params__.frozen)

    at_solver, at_experimental = autotune.autotune_key_fields()
    return dict(
        solver_fields=frozenset(
            f.name for f in dataclasses.fields(SolverConfig)),
        experimental_fields=frozenset(
            f.name for f in dataclasses.fields(ExperimentalConfig)),
        fingerprint_covered=registry.fingerprint_solver_fields(),
        fingerprint_excluded=tuple(registry.FINGERPRINT_SOLVER_EXCLUDED),
        fingerprint_resolved=tuple(registry.FINGERPRINT_SOLVER_RESOLVED),
        declared_non_numerics=tuple(SolverConfig.NON_NUMERICS_FIELDS),
        exec_key_covered=exec_cache.solver_key_fields(),
        persist_key_covered=exec_cache.persist_key_fields(),
        data_fields=frozenset(
            f.name for f in dataclasses.fields(data_cache.DataKey)),
        data_key_covered=data_cache.data_key_fields(),
        serve_fields=frozenset(
            f.name for f in dataclasses.fields(serve.ServeConfig)),
        serve_key_covered=serve.serve_key_fields(),
        hashable_configs={"SolverConfig": _hashable(SolverConfig),
                          "ExperimentalConfig": _hashable(
                              ExperimentalConfig),
                          "DataKey": _hashable(data_cache.DataKey),
                          "ServeConfig": _hashable(serve.ServeConfig)},
        noncompare_fields={
            cls.__name__: tuple(f.name
                                for f in dataclasses.fields(cls)
                                if not f.compare)
            for cls in (SolverConfig, ExperimentalConfig)},
        nonrepr_fields={
            cls.__name__: tuple(f.name
                                for f in dataclasses.fields(cls)
                                if not f.repr)
            for cls in (SolverConfig, ExperimentalConfig)},
        autotune_solver_covered=at_solver,
        autotune_experimental_covered=at_experimental,
        autotune_exempt_solver=tuple(
            sorted(autotune.AUTOTUNE_EXEMPT_SOLVER)),
        autotune_exempt_experimental=tuple(
            sorted(autotune.AUTOTUNE_EXEMPT_EXPERIMENTAL)),
    )


def check_manifest_coverage(
    solver_fields: "frozenset[str]",
    consensus_fields: "frozenset[str]",
    manifest_solver: "frozenset[str]",
    manifest_consensus: "frozenset[str]",
    declared_non_numerics: "tuple[str, ...]",
    manifest_consensus_excluded: "tuple[str, ...]",
    declared_checkpoint_exempt: "tuple[str, ...]",
) -> "list[str]":
    """NMFX007's pure contract check (the ``check_config_coverage``
    pattern): every result-affecting ``SolverConfig``/``ConsensusConfig``
    field must appear in ``checkpoint.manifest_key_fields()`` or be
    explicitly declared exempt — a field invisible to the manifest lets
    a durable-sweep ledger written under one configuration resume under
    another (plausible records, wrong numbers, no crash: the
    stale-resume class). Tests inject mutated universes; the Rule
    wrapper reads the live modules."""
    problems: "list[str]" = []
    # 1. declarations must not go stale
    for name in declared_checkpoint_exempt:
        if name not in consensus_fields:
            problems.append(
                f"ConsensusConfig.CHECKPOINT_EXEMPT_FIELDS names {name!r}, "
                "which is not a ConsensusConfig field — stale declaration")
    # 2. every manifest exclusion must be a declared exempt field
    for name in manifest_consensus_excluded:
        if name not in declared_checkpoint_exempt:
            problems.append(
                f"ConsensusConfig.{name} is excluded from the checkpoint "
                "manifest (checkpoint.MANIFEST_CONSENSUS_EXCLUDED) but "
                "not declared in "
                "ConsensusConfig.CHECKPOINT_EXEMPT_FIELDS — a result-"
                "affecting field excluded from the manifest resumes "
                "stale ledgers silently")
    # 3. every SolverConfig field must reach the manifest unless it is
    #    declared execution-strategy-only (the registry-fingerprint
    #    discipline, shared declaration)
    for name in sorted(solver_fields - manifest_solver):
        if name not in declared_non_numerics:
            problems.append(
                f"SolverConfig.{name} does not reach the checkpoint "
                "manifest (checkpoint.manifest_key_fields()['solver']) "
                "and is not declared in NON_NUMERICS_FIELDS — ledgers "
                "written under different values of it would resume "
                "interchangeably")
    # 4. every ConsensusConfig field must reach the manifest unless
    #    declared checkpoint-exempt (with its rationale on record)
    for name in sorted(consensus_fields - manifest_consensus):
        if name not in declared_checkpoint_exempt:
            problems.append(
                f"ConsensusConfig.{name} does not reach the checkpoint "
                "manifest (checkpoint.manifest_key_fields()"
                "['consensus']) and is not declared in "
                "CHECKPOINT_EXEMPT_FIELDS — ledgers written under "
                "different values of it would resume interchangeably")
    return problems


def _live_manifest_universe():
    from nmfx_torch import checkpoint
    from nmfx_torch.config import ConsensusConfig, SolverConfig

    covered = checkpoint.manifest_key_fields()
    return dict(
        solver_fields=frozenset(
            f.name for f in dataclasses.fields(SolverConfig)),
        consensus_fields=frozenset(
            f.name for f in dataclasses.fields(ConsensusConfig)),
        manifest_solver=covered["solver"],
        manifest_consensus=covered["consensus"],
        declared_non_numerics=tuple(SolverConfig.NON_NUMERICS_FIELDS),
        manifest_consensus_excluded=tuple(
            checkpoint.MANIFEST_CONSENSUS_EXCLUDED),
        declared_checkpoint_exempt=tuple(
            ConsensusConfig.CHECKPOINT_EXEMPT_FIELDS),
    )


@register
class CheckpointManifestCoverage(Rule):
    """NMFX007: every result-affecting SolverConfig/ConsensusConfig
    field must reach the durable-sweep checkpoint manifest
    (``nmfx_torch.checkpoint.manifest_key_fields``) or be explicitly declared
    exempt with its rationale."""

    rule_id = "NMFX007"
    title = "checkpoint-manifest coverage"

    def check(self, project) -> "Iterable[Finding]":
        # semantic whole-package rule, same gating as NMFX001: run only
        # when the real package is the analyzed set, and only against
        # the checkout the import machinery actually resolves
        import os

        analyzed_cfg = next(
            (m.path for m in project.modules
             if m.path.replace("\\", "/").endswith("nmfx_torch/config.py")),
            None)
        if analyzed_cfg is None:
            return []
        from nmfx_torch.config import ConsensusConfig

        cfg_file, cfg_line = _decl_site(ConsensusConfig,
                                        "nmfx_torch/config.py")
        if os.path.abspath(cfg_file) != os.path.abspath(analyzed_cfg):
            # NMFX001 already reports the wrong-tree condition loudly;
            # don't double-report it per rule
            return []
        return [self.finding(cfg_file, cfg_line, msg)
                for msg in check_manifest_coverage(
                    **_live_manifest_universe())]


def check_result_cache_coverage(
    solver_fields: "frozenset[str]",
    consensus_fields: "frozenset[str]",
    cache_solver: "frozenset[str]",
    cache_consensus: "frozenset[str]",
    declared_non_numerics: "tuple[str, ...]",
    declared_result_cache_exempt: "tuple[str, ...]",
) -> "list[str]":
    """NMFX011's pure contract check (the ``check_config_coverage``
    pattern): every result-affecting ``SolverConfig``/``ConsensusConfig``
    field must appear in ``result_cache.cache_key_fields()`` or be
    explicitly declared exempt. A field invisible to the result-cache
    key lets a finished consensus computed under one configuration be
    SERVED verbatim to a request for another — plausible result, wrong
    numbers, no crash, and unlike a stale checkpoint resume the cache
    replays it in O(1) forever. Note the asymmetry with NMFX007: the
    checkpoint ledger legitimately exempts ``restarts``/``ks`` (its
    per-(k, chunk) records make them resumable deltas), but the result
    cache stores the FINISHED result, so those fields MUST be in this
    key — which is why the exemption list is a separate declaration
    (``ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS``), not a reuse of
    ``CHECKPOINT_EXEMPT_FIELDS``. Tests inject mutated universes; the
    Rule wrapper reads the live modules."""
    problems: "list[str]" = []
    # 1. declarations must not go stale
    for name in declared_result_cache_exempt:
        if name not in consensus_fields:
            problems.append(
                "ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS names "
                f"{name!r}, which is not a ConsensusConfig field — "
                "stale declaration")
    # 2. every SolverConfig field must reach the result-cache key
    #    unless declared execution-strategy-only (the shared
    #    NON_NUMERICS_FIELDS declaration: those fields change
    #    scheduling, never the finished numbers, so excluding them is
    #    what makes a restart_chunk-retuned rerun a HIT)
    for name in sorted(solver_fields - cache_solver):
        if name not in declared_non_numerics:
            problems.append(
                f"SolverConfig.{name} does not reach the result-cache "
                "key (result_cache.cache_key_fields()['solver']) and "
                "is not declared in NON_NUMERICS_FIELDS — finished "
                "results computed under different values of it would "
                "be served interchangeably")
    # 3. every ConsensusConfig field must reach the key unless
    #    declared result-cache-exempt (with its rationale on record)
    for name in sorted(consensus_fields - cache_consensus):
        if name not in declared_result_cache_exempt:
            problems.append(
                f"ConsensusConfig.{name} does not reach the result-"
                "cache key (result_cache.cache_key_fields()"
                "['consensus']) and is not declared in "
                "RESULT_CACHE_EXEMPT_FIELDS — finished results "
                "computed under different values of it would be "
                "served interchangeably")
    # 4. a field both declared exempt AND covered is a contradictory
    #    declaration — one of the two is stale
    for name in declared_result_cache_exempt:
        if name in cache_consensus:
            problems.append(
                f"ConsensusConfig.{name} is declared in "
                "RESULT_CACHE_EXEMPT_FIELDS but still reaches the "
                "result-cache key — contradictory declarations; "
                "drop one")
    return problems


def _live_result_cache_universe():
    from nmfx_torch import result_cache
    from nmfx_torch.config import ConsensusConfig, SolverConfig

    covered = result_cache.cache_key_fields()
    return dict(
        solver_fields=frozenset(
            f.name for f in dataclasses.fields(SolverConfig)),
        consensus_fields=frozenset(
            f.name for f in dataclasses.fields(ConsensusConfig)),
        cache_solver=covered["solver"],
        cache_consensus=covered["consensus"],
        declared_non_numerics=tuple(SolverConfig.NON_NUMERICS_FIELDS),
        declared_result_cache_exempt=tuple(
            ConsensusConfig.RESULT_CACHE_EXEMPT_FIELDS),
    )


@register
class ResultCacheKeyCoverage(Rule):
    """NMFX011: every result-affecting SolverConfig/ConsensusConfig
    field must reach the content-addressed result-cache key
    (``nmfx_torch.result_cache.cache_key_fields``) or be explicitly declared
    exempt with its rationale."""

    rule_id = "NMFX011"
    title = "result-cache key coverage"

    def check(self, project) -> "Iterable[Finding]":
        # semantic whole-package rule, same gating as NMFX001/007: run
        # only when the real package is the analyzed set, and only
        # against the checkout the import machinery actually resolves
        import os

        analyzed_cfg = next(
            (m.path for m in project.modules
             if m.path.replace("\\", "/").endswith("nmfx_torch/config.py")),
            None)
        if analyzed_cfg is None:
            return []
        from nmfx_torch.config import ConsensusConfig

        cfg_file, cfg_line = _decl_site(ConsensusConfig,
                                        "nmfx_torch/config.py")
        if os.path.abspath(cfg_file) != os.path.abspath(analyzed_cfg):
            # NMFX001 already reports the wrong-tree condition loudly;
            # don't double-report it per rule
            return []
        return [self.finding(cfg_file, cfg_line, msg)
                for msg in check_result_cache_coverage(
                    **_live_result_cache_universe())]


@register
class ConfigFingerprintCoverage(Rule):
    """NMFX001: every numerics-affecting config field must reach the
    registry fingerprint and the exec-cache bucket key."""

    rule_id = "NMFX001"
    title = "config-fingerprint coverage"

    def check(self, project) -> "Iterable[Finding]":
        # this is a semantic whole-package rule: it runs only when the
        # real package is in the analyzed set (fixture runs over test
        # snippets call check_config_coverage directly)
        import os

        analyzed_cfg = next(
            (m.path for m in project.modules
             if m.path.replace("\\", "/").endswith("nmfx_torch/config.py")),
            None)
        if analyzed_cfg is None:
            return []
        from nmfx_torch.config import SolverConfig

        cfg_file, cfg_line = _decl_site(SolverConfig,
                                        "nmfx_torch/config.py")
        # this rule checks the IMPORTED package;
        # if the import resolves outside the analyzed checkout (a stale
        # site-packages install shadowing a worktree), the results
        # would describe the wrong tree — fail loudly instead
        if os.path.abspath(cfg_file) != os.path.abspath(analyzed_cfg):
            return [self.finding(
                analyzed_cfg, 1,
                f"the importable nmfx_torch package resolves to "
                f"{cfg_file!r}, not the analyzed {analyzed_cfg!r} — "
                "NMFX001 would check the WRONG tree. Run the linter "
                "with the analyzed checkout first on sys.path (e.g. "
                "`PYTHONPATH=<checkout> python -m nmfx_torch.analysis "
                "<checkout>/nmfx_torch`)")]
        return [self.finding(cfg_file, cfg_line, msg)
                for msg in check_config_coverage(**_live_universe())]
