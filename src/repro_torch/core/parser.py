"""``.swirl`` surface syntax — tokenizer + recursive-descent parser.

The paper's reference toolchain uses ANTLR-generated Python3 parsers; ANTLR is
unavailable offline, so the same surface grammar is implemented by hand.  The
grammar below round-trips exactly the ``pretty()`` form of
:mod:`repro_torch.core.syntax`::

    system  := config ("|" config)*
    config  := "<" NAME "," dataset "," trace ">"
    dataset := "{" [NAME ("," NAME)*] "}"
    trace   := par
    par     := seqe ("|" seqe)*
    seqe    := term ("." term)*
    term    := "0" | action | "(" trace ")"
    action  := "exec" "(" NAME "," dataset "->" dataset "," "{" names "}" ")"
             | "send" "(" NAME "->" NAME "," NAME "," NAME ")"
             | "recv" "(" NAME "," NAME "," NAME ")"

Identifiers are ``[A-Za-z0-9_^$]+`` (no dots — ``.`` is sequential
composition).  ``#`` starts a line comment.  Whitespace is insignificant.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .syntax import (
    NIL,
    Exec,
    LocationConfig,
    Recv,
    Send,
    Trace,
    WorkflowSystem,
    par,
    seq,
)

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<arrow>->)
  | (?P<punct>[<>(){},.|])
  | (?P<name>[A-Za-z0-9_^$]+)
    """,
    re.VERBOSE,
)


class SwirlSyntaxError(ValueError):
    """Raised on malformed ``.swirl`` input, with position info.

    Carries structured location attributes so front ends (the HTTP gateway,
    editors) can point at the offending character without re-parsing the
    message: ``offset`` is the 0-based character offset into the source,
    ``line``/``column`` are 1-based when the source is known (``None``
    otherwise).
    """

    def __init__(
        self,
        message: str,
        *,
        offset: int | None = None,
        line: int | None = None,
        column: int | None = None,
    ):
        super().__init__(message)
        self.offset = offset
        self.line = line
        self.column = column


def _line_col(src: str, offset: int) -> tuple[int, int]:
    """1-based (line, column) of character ``offset`` in ``src``."""
    offset = min(max(offset, 0), len(src))
    line = src.count("\n", 0, offset) + 1
    column = offset - (src.rfind("\n", 0, offset) + 1) + 1
    return line, column


def _syntax_error(src: str, message: str, offset: int) -> SwirlSyntaxError:
    line, column = _line_col(src, offset)
    return SwirlSyntaxError(
        f"{message} at line {line}, column {column}",
        offset=offset,
        line=line,
        column=column,
    )


@dataclass
class _Tok:
    kind: str  # 'arrow' | 'punct' | 'name' | 'eof'
    text: str
    pos: int


def tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise _syntax_error(src, f"unexpected character {src[i]!r}", i)
        i = m.end()
        kind = m.lastgroup or ""
        if kind == "ws":
            continue
        toks.append(_Tok(kind, m.group(), m.start()))
    toks.append(_Tok("eof", "", len(src)))
    return toks


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = tokenize(src)
        self.i = 0

    # -- token helpers -------------------------------------------------------
    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def error(self, message: str, pos: int) -> SwirlSyntaxError:
        return _syntax_error(self.src, message, pos)

    def expect(self, text: str) -> _Tok:
        t = self.next()
        if t.text != text:
            raise self.error(
                f"expected {text!r} but found {t.text or 'EOF'!r}", t.pos
            )
        return t

    def name(self) -> str:
        t = self.next()
        if t.kind != "name":
            raise self.error(
                f"expected identifier but found {t.text or 'EOF'!r}", t.pos
            )
        return t.text

    # -- grammar -------------------------------------------------------------
    def system(self) -> WorkflowSystem:
        configs = [self.config()]
        while self.peek().text == "|":
            self.next()
            configs.append(self.config())
        if self.peek().kind != "eof":
            t = self.peek()
            raise self.error(f"trailing input {t.text!r}", t.pos)
        return WorkflowSystem(tuple(configs))

    def config(self) -> LocationConfig:
        self.expect("<")
        loc = self.name()
        self.expect(",")
        data = self.dataset()
        self.expect(",")
        trace = self.par()
        self.expect(">")
        return LocationConfig(loc, data, trace)

    def dataset(self) -> frozenset[str]:
        self.expect("{")
        items: list[str] = []
        if self.peek().text != "}":
            items.append(self.name())
            while self.peek().text == ",":
                self.next()
                items.append(self.name())
        self.expect("}")
        return frozenset(items)

    def par(self) -> Trace:
        branches = [self.seqe()]
        while self.peek().text == "|":
            self.next()
            branches.append(self.seqe())
        return par(*branches)

    def seqe(self) -> Trace:
        items = [self.term()]
        while self.peek().text == ".":
            self.next()
            items.append(self.term())
        return seq(*items)

    def term(self) -> Trace:
        t = self.peek()
        if t.text == "(":
            self.next()
            inner = self.par()
            self.expect(")")
            return inner
        if t.text == "0":
            self.next()
            return NIL
        if t.text in ("exec", "send", "recv"):
            return self.action()
        raise self.error(
            f"expected a trace term but found {t.text or 'EOF'!r}", t.pos
        )

    def action(self) -> Trace:
        kw_pos = self.peek().pos
        kw = self.name()
        self.expect("(")
        if kw == "exec":
            step = self.name()
            self.expect(",")
            ins = self.dataset()
            self.expect("->")
            outs = self.dataset()
            self.expect(",")
            self.expect("{")
            locs: list[str] = []
            if self.peek().text != "}":
                locs.append(self.name())
                while self.peek().text == ",":
                    self.next()
                    locs.append(self.name())
            self.expect("}")
            self.expect(")")
            return Exec(step, ins, outs, tuple(locs))
        if kw == "send":
            d = self.name()
            self.expect("->")
            p = self.name()
            self.expect(",")
            src = self.name()
            self.expect(",")
            dst = self.name()
            self.expect(")")
            return Send(d, p, src, dst)
        if kw == "recv":
            p = self.name()
            self.expect(",")
            src = self.name()
            self.expect(",")
            dst = self.name()
            self.expect(")")
            return Recv(p, src, dst)
        raise self.error(f"unknown action {kw!r}", kw_pos)


def parse_system(src: str) -> WorkflowSystem:
    """Parse a full ``.swirl`` workflow system."""
    return _Parser(src).system()


def parse_trace(src: str) -> Trace:
    """Parse a bare execution trace (used in tests and the REPL)."""
    p = _Parser(src)
    t = p.par()
    if p.peek().kind != "eof":
        tok = p.peek()
        raise p.error(f"trailing input {tok.text!r}", tok.pos)
    return t


def dumps(w: WorkflowSystem) -> str:
    """Emit the canonical ``.swirl`` text (inverse of :func:`parse_system`)."""
    return " |\n".join(c.pretty() for c in w.configs)


def loads(src: str) -> WorkflowSystem:
    return parse_system(src)
