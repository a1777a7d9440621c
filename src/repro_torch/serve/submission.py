"""Submission decoding: DAG-JSON / ``.swirl`` bodies → :class:`Plan`.

A copy of ``repro/serve/submission.py``.

Every malformed submission surfaces as a typed :class:`SubmissionError` —
the gateway turns it into a ``400`` with a JSON error body carrying the
error ``kind`` and, for ``.swirl`` syntax errors, the 1-based
``line``/``column`` from :mod:`repro_torch.core.parser`.  A raw traceback never
crosses the HTTP boundary.

Accepted submission bodies (JSON object unless noted):

* ``{"swirl": "<text>", "rules": [...]}`` — ``.swirl`` surface syntax;
* ``{"dag": {"edges": {...}, "mapping": {...}, "initial_data": {...}},
  "rules": [...]}`` — the step-adjacency DAG-JSON of
  :class:`repro_torch.core.translate.DagTranslator`;
* a plain string (``Content-Type: text/plain`` at the gateway) —
  shorthand for ``{"swirl": <body>}``.

``rules`` defaults to the paper's ``("R1R2",)`` and must name entries of
:data:`repro_torch.core.optimizer.REWRITE_RULES`.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

from repro_torch.api import Plan, trace
from repro_torch.core.optimizer import REWRITE_RULES
from repro_torch.core.parser import SwirlSyntaxError, parse_system
from repro_torch.core.translate import DagTranslator

__all__ = ["SubmissionError", "compile_submission", "parse_payload_keys"]

DEFAULT_RULES = ("R1R2",)

#: The ``.swirl`` identifier alphabet.  Enforced on DAG-JSON names too so
#: the canonical text round-trips and the gateway's ``location:datum``
#: payload keys / ``#tag`` endpoint namespaces can never be ambiguous.
_IDENT = re.compile(r"[A-Za-z0-9_^$]+\Z")


class SubmissionError(ValueError):
    """A workflow submission the gateway must reject with a 400.

    ``kind`` classifies the failure (``"json"``, ``"schema"``,
    ``"swirl-syntax"``, ``"dag"``, ``"rules"``, ``"steps"``,
    ``"inputs"``); ``line``/``column`` are 1-based positions for
    ``.swirl`` syntax errors (``None`` otherwise).
    """

    def __init__(
        self,
        message: str,
        *,
        kind: str = "schema",
        line: int | None = None,
        column: int | None = None,
    ):
        super().__init__(message)
        self.kind = kind
        self.line = line
        self.column = column

    def to_json(self) -> dict[str, Any]:
        body: dict[str, Any] = {
            "type": "SubmissionError",
            "kind": self.kind,
            "message": str(self),
        }
        if self.line is not None:
            body["line"] = self.line
        if self.column is not None:
            body["column"] = self.column
        return body


def _require(cond: bool, message: str, *, kind: str = "schema") -> None:
    if not cond:
        raise SubmissionError(message, kind=kind)


def _check_ident(name: Any, what: str, *, kind: str) -> str:
    _require(
        isinstance(name, str) and bool(_IDENT.match(name)),
        f"{what} {name!r} is not a valid identifier "
        "([A-Za-z0-9_^$]+, no dots/colons)",
        kind=kind,
    )
    return name


def _validate_rules(rules: Any) -> tuple[str, ...]:
    if rules is None:
        return DEFAULT_RULES
    _require(
        isinstance(rules, (list, tuple))
        and all(isinstance(r, str) for r in rules),
        "'rules' must be a list of rule names",
        kind="rules",
    )
    unknown = [r for r in rules if r not in REWRITE_RULES]
    _require(
        not unknown,
        f"unknown rewrite rules {unknown}; known: {sorted(REWRITE_RULES)}",
        kind="rules",
    )
    return tuple(rules)


def _dag_instance(dag: Any) -> DagTranslator:
    _require(
        isinstance(dag, Mapping),
        "'dag' must be an object with 'edges' and 'mapping'",
        kind="dag",
    )
    unknown = set(dag) - {"edges", "mapping", "initial_data"}
    _require(
        not unknown,
        f"unknown 'dag' fields {sorted(unknown)}; "
        "allowed: edges, mapping, initial_data",
        kind="dag",
    )
    edges = dag.get("edges")
    mapping = dag.get("mapping")
    _require(
        isinstance(edges, Mapping) and len(edges) > 0,
        "'dag.edges' must be a non-empty object {step: [successor, ...]}",
        kind="dag",
    )
    _require(
        isinstance(mapping, Mapping) and len(mapping) > 0,
        "'dag.mapping' must be a non-empty object {step: [location, ...]}",
        kind="dag",
    )
    steps: set[str] = set()
    for s, succs in edges.items():
        _check_ident(s, "step", kind="dag")
        _require(
            isinstance(succs, (list, tuple)),
            f"'dag.edges[{s!r}]' must be a list of successor steps",
            kind="dag",
        )
        steps.add(s)
        for t in succs:
            steps.add(_check_ident(t, "step", kind="dag"))
    placed: set[str] = set()
    locations: set[str] = set()
    for s, locs in mapping.items():
        _check_ident(s, "step", kind="dag")
        _require(
            isinstance(locs, (list, tuple)) and len(locs) > 0,
            f"'dag.mapping[{s!r}]' must be a non-empty list of locations",
            kind="dag",
        )
        placed.add(s)
        for l in locs:
            locations.add(_check_ident(l, "location", kind="dag"))
    unplaced = steps - placed
    _require(
        not unplaced,
        f"steps {sorted(unplaced)} appear in 'edges' but have no "
        "'mapping' entry (every step needs M(s))",
        kind="dag",
    )
    extra = placed - steps
    _require(
        not extra,
        f"'mapping' names steps {sorted(extra)} that never appear in "
        "'edges'",
        kind="dag",
    )
    initial = dag.get("initial_data") or {}
    _require(
        isinstance(initial, Mapping),
        "'dag.initial_data' must be an object {location: [datum, ...]}",
        kind="dag",
    )
    # The translator materialises exactly one datum d^s per producer step;
    # initial_data may only seed those (anything else fails deep in the
    # graph model — catch it here with an explanation instead).
    produced = sorted(f"d^{s}" for s, succs in edges.items() if succs)
    for l, ds in initial.items():
        _require(
            l in locations,
            f"'initial_data' location {l!r} is not used by any step "
            f"(locations: {sorted(locations)})",
            kind="dag",
        )
        _require(
            isinstance(ds, (list, tuple)),
            f"'dag.initial_data[{l!r}]' must be a list of data elements",
            kind="dag",
        )
        for d in ds:
            _check_ident(d, "datum", kind="dag")
            _require(
                d in produced,
                f"'initial_data' datum {d!r} is not produced by any step; "
                f"this DAG's data elements are {produced}",
                kind="dag",
            )
    translator = DagTranslator(
        edges={s: tuple(ts) for s, ts in edges.items()},
        mapping={s: tuple(ls) for s, ls in mapping.items()},
        initial_data={l: tuple(ds) for l, ds in initial.items()},
    )
    try:
        translator.instance()
    except ValueError as e:
        # Any residual graph-model validation failure is still the
        # submitter's problem, not a server error.
        raise SubmissionError(str(e), kind="dag") from e
    return translator


def compile_submission(body: Any) -> tuple[Plan, dict[str, Any]]:
    """Decode one submission body into an optimised :class:`Plan`.

    Returns ``(plan, meta)`` where ``meta`` records the source format and
    the rule list applied.  Raises :class:`SubmissionError` on any
    malformed input.
    """
    if isinstance(body, str):
        body = {"swirl": body}
    _require(
        isinstance(body, Mapping),
        "submission must be a JSON object (or raw .swirl text)",
        kind="schema",
    )
    unknown = set(body) - {"swirl", "dag", "rules"}
    _require(
        not unknown,
        f"unknown submission fields {sorted(unknown)}; "
        "allowed: swirl, dag, rules",
        kind="schema",
    )
    rules = _validate_rules(body.get("rules"))
    has_swirl = "swirl" in body
    has_dag = "dag" in body
    _require(
        has_swirl != has_dag,
        "submission needs exactly one of 'swirl' (surface text) or 'dag' "
        "(edges + mapping)",
        kind="schema",
    )
    if has_swirl:
        text = body["swirl"]
        _require(
            isinstance(text, str) and text.strip(),
            "'swirl' must be non-empty .swirl source text",
            kind="schema",
        )
        try:
            system = parse_system(text)
        except SwirlSyntaxError as e:
            raise SubmissionError(
                str(e), kind="swirl-syntax", line=e.line, column=e.column
            ) from e
        plan = trace(system)
        fmt = "swirl"
    else:
        plan = trace(_dag_instance(body["dag"]).instance())
        fmt = "dag"
    if rules:
        plan = plan.optimize(rules)
    return plan, {"format": fmt, "rules": list(rules)}


def parse_payload_keys(
    inputs: Any, locations: frozenset[str] | set[str]
) -> dict[tuple[str, str], Any]:
    """``{"location:datum": value}`` → ``{(location, datum): value}``.

    The colon separator can never appear inside an identifier, so the
    split is unambiguous.  Unknown locations are rejected (a typo would
    otherwise silently strand the payload and the run would time out).
    """
    if inputs is None:
        return {}
    if not isinstance(inputs, Mapping):
        raise SubmissionError(
            "'inputs' must be an object {\"location:datum\": value}",
            kind="inputs",
        )
    payloads: dict[tuple[str, str], Any] = {}
    for key, value in inputs.items():
        loc, sep, datum = str(key).partition(":")
        if not sep or not loc or not datum:
            raise SubmissionError(
                f"payload key {key!r} must be 'location:datum'",
                kind="inputs",
            )
        if loc not in locations:
            raise SubmissionError(
                f"payload key {key!r} names unknown location {loc!r} "
                f"(locations: {sorted(locations)})",
                kind="inputs",
            )
        payloads[(loc, datum)] = value
    return payloads
