"""SWIRL syntax — Definition 8 of the paper.

::

    W ::= ⟨l, D, e⟩ | (W1 | W2)
    e ::= μ | e1.e2 | (e1 | e2) | 0
    μ ::= exec(s, F(s), M(s)) | send(d↣p, l, l') | recv(p, l, l')
    F(s) ::= In^D(s) ↦ Out^D(s)

Traces are immutable hashable trees.  ``Seq``/``Par`` are n-ary and kept in
*source order* (the order matters for readability and paper-exactness tests);
structural congruence (Fig. 2) is provided by :func:`normalize` /
:func:`congruent`, which flatten nested compositions, drop ``0`` units and
compare ``Par`` branches up to permutation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, Mapping, Union


# ---------------------------------------------------------------------------
# Predicates μ
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Exec:
    """``exec(s, In^D(s) ↦ Out^D(s), M(s))``."""

    step: str
    inputs: frozenset[str]
    outputs: frozenset[str]
    locations: tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "inputs", frozenset(self.inputs))
        object.__setattr__(self, "outputs", frozenset(self.outputs))
        object.__setattr__(self, "locations", tuple(self.locations))

    def pretty(self) -> str:
        ins = "{" + ",".join(sorted(self.inputs)) + "}"
        outs = "{" + ",".join(sorted(self.outputs)) + "}"
        locs = "{" + ",".join(self.locations) + "}"
        return f"exec({self.step},{ins}->{outs},{locs})"


@dataclass(frozen=True)
class Send:
    """``send(d ↣ p, l, l')`` — transfer data ``d`` over port ``p``."""

    data: str
    port: str
    src: str
    dst: str

    def pretty(self) -> str:
        return f"send({self.data}->{self.port},{self.src},{self.dst})"


@dataclass(frozen=True)
class Recv:
    """``recv(p, l, l')`` — receive over port ``p`` from ``l`` at ``l'``."""

    port: str
    src: str
    dst: str

    def pretty(self) -> str:
        return f"recv({self.port},{self.src},{self.dst})"


Action = Union[Exec, Send, Recv]


# ---------------------------------------------------------------------------
# Traces e
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Nil:
    """The empty trace ``0``."""

    def pretty(self) -> str:
        return "0"


@dataclass(frozen=True)
class Seq:
    """``e1.e2...`` — n-ary sequential composition."""

    items: tuple["Trace", ...]

    def pretty(self) -> str:
        return ".".join(_paren(t, inside="seq") for t in self.items)


@dataclass(frozen=True)
class Par:
    """``e1 | e2 | ...`` — n-ary parallel composition."""

    branches: tuple["Trace", ...]

    def pretty(self) -> str:
        return " | ".join(_paren(t, inside="par") for t in self.branches)


Trace = Union[Nil, Seq, Par, Exec, Send, Recv]

NIL = Nil()


def _paren(t: Trace, inside: str) -> str:
    s = t.pretty()
    if inside == "seq" and isinstance(t, (Par, Seq)):
        return f"({s})"
    if inside == "par" and isinstance(t, Par):
        return f"({s})"
    return s


# ---------------------------------------------------------------------------
# Smart constructors (apply the Fig. 2 identities eagerly)
# ---------------------------------------------------------------------------


def seq(*items: Trace) -> Trace:
    """Sequential composition with ``0.e ≡ e ∧ e.0 ≡ e`` (Id.) and flattening."""
    flat: list[Trace] = []
    for it in items:
        if isinstance(it, Nil):
            continue
        if isinstance(it, Seq):
            flat.extend(it.items)
        else:
            flat.append(it)
    if not flat:
        return NIL
    if len(flat) == 1:
        return flat[0]
    return Seq(tuple(flat))


def par(*branches: Trace) -> Trace:
    """Parallel composition with ``e | 0 ≡ e`` (Id|) and flattening."""
    flat: list[Trace] = []
    for b in branches:
        if isinstance(b, Nil):
            continue
        if isinstance(b, Par):
            flat.extend(b.branches)
        else:
            flat.append(b)
    if not flat:
        return NIL
    if len(flat) == 1:
        return flat[0]
    return Par(tuple(flat))


def is_action(t: Trace) -> bool:
    return isinstance(t, (Exec, Send, Recv))


def actions(t: Trace) -> Iterator[Action]:
    """All predicate occurrences in ``t`` in left-to-right program order."""
    if is_action(t):
        yield t  # type: ignore[misc]
    elif isinstance(t, Seq):
        for it in t.items:
            yield from actions(it)
    elif isinstance(t, Par):
        for b in t.branches:
            yield from actions(b)


def size(t: Trace) -> int:
    return sum(1 for _ in actions(t))


# ---------------------------------------------------------------------------
# Structural congruence (Fig. 2)
# ---------------------------------------------------------------------------


def normalize(t: Trace) -> Trace:
    """Normal form: flatten, drop units, sort ``Par`` branches canonically.

    Two traces are structurally congruent iff their normal forms are equal
    (COMT_u commutes parallel branches; Id rules drop ``0``).
    """
    if is_action(t) or isinstance(t, Nil):
        return t
    if isinstance(t, Seq):
        return seq(*(normalize(i) for i in t.items))
    if isinstance(t, Par):
        norm = [normalize(b) for b in t.branches]
        norm = [b for b in norm if not isinstance(b, Nil)]
        norm.sort(key=_trace_key)
        return par(*norm)
    raise TypeError(f"not a trace: {t!r}")


def _trace_key(t: Trace) -> str:
    return normalize(t).pretty() if isinstance(t, (Seq, Par)) else t.pretty()


def congruent(a: Trace, b: Trace) -> bool:
    """``a ≡ b`` under the Fig. 2 structural congruence."""
    return normalize(a) == normalize(b)


# ---------------------------------------------------------------------------
# Workflow systems W (parallel composition of location configurations)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LocationConfig:
    """``⟨l, D, e⟩`` — location name, resident data, execution trace."""

    location: str
    data: frozenset[str]
    trace: Trace

    def __post_init__(self) -> None:
        object.__setattr__(self, "data", frozenset(self.data))

    def pretty(self) -> str:
        d = "{" + ",".join(sorted(self.data)) + "}"
        return f"<{self.location},{d},{self.trace.pretty()}>"


@dataclass(frozen=True)
class WorkflowSystem:
    """``W = Π_i ⟨l_i, D_i, e_i⟩`` with one configuration per location."""

    configs: tuple[LocationConfig, ...]

    def __post_init__(self) -> None:
        names = [c.location for c in self.configs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate location configuration: {names}")

    # -- accessors ----------------------------------------------------------
    def locations(self) -> tuple[str, ...]:
        return tuple(c.location for c in self.configs)

    def __getitem__(self, location: str) -> LocationConfig:
        for c in self.configs:
            if c.location == location:
                return c
        raise KeyError(location)

    def replace(self, location: str, *, data=None, trace=None) -> "WorkflowSystem":
        new = []
        for c in self.configs:
            if c.location == location:
                c = LocationConfig(
                    location,
                    frozenset(data) if data is not None else c.data,
                    trace if trace is not None else c.trace,
                )
            new.append(c)
        return WorkflowSystem(tuple(new))

    def is_terminated(self) -> bool:
        """All traces are ``≡ 0`` — the plan ran to completion."""
        return all(isinstance(normalize(c.trace), Nil) for c in self.configs)

    def pretty(self) -> str:
        return " |\n".join(c.pretty() for c in self.configs)

    def canonical(self) -> str:
        """Canonical string up to structural congruence (state-space key)."""
        parts = []
        for c in sorted(self.configs, key=lambda c: c.location):
            d = ",".join(sorted(c.data))
            parts.append(f"<{c.location}|{d}|{normalize(c.trace).pretty()}>")
        return "||".join(parts)

    def total_actions(self) -> int:
        return sum(size(c.trace) for c in self.configs)

    def comm_count(self) -> int:
        """Number of ``send``/``recv`` predicates in the whole system."""
        n = 0
        for c in self.configs:
            for a in actions(c.trace):
                if isinstance(a, (Send, Recv)):
                    n += 1
        return n

    def send_count(self) -> int:
        return sum(
            1
            for c in self.configs
            for a in actions(c.trace)
            if isinstance(a, Send)
        )


def system(*configs: LocationConfig) -> WorkflowSystem:
    return WorkflowSystem(tuple(configs))


def config(location: str, data: Iterable[str], trace: Trace) -> LocationConfig:
    return LocationConfig(location, frozenset(data), trace)
