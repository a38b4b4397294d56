"""Visibility expressions + authorizations.

≙ reference `geomesa-security` (SURVEY.md §2.11): `VisibilityEvaluator`
(security/VisibilityEvaluator.scala:22,156 — Accumulo-style boolean label
expressions ``admin&(user|ops)``), `AuthorizationsProvider` SPI, and the
per-feature `VisibilityFilter`. Columnar twist: visibilities are dictionary
-encoded per feature table, so a query evaluates each DISTINCT expression
against the caller's auths once on the host, and enforcement on device is a
tiny code-membership mask — no per-row expression evaluation anywhere.

Grammar (Accumulo visibility subset)::

    expr   := term (('&' | '|') term)*    # one operator kind per level
    term   := label | quoted | '(' expr ')'
    label  := [A-Za-z0-9_.:-]+            # or "quoted string"

Empty expression = visible to everyone.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence

import numpy as np

_LABEL = re.compile(r'[A-Za-z0-9_.:+/-]+|"(?:[^"\\]|\\.)*"')


class VisibilityError(ValueError):
    pass


def parse_visibility(expr: str):
    """Expression AST: label str | ('&'|'|', [children]). Raises
    VisibilityError on malformed input."""
    expr = expr.strip()
    if not expr:
        return None
    node, pos = _parse_expr(expr, 0)
    if pos != len(expr):
        raise VisibilityError(f"Trailing input in visibility {expr!r}")
    return node


def _parse_expr(s: str, pos: int):
    terms = []
    op = None
    while True:
        term, pos = _parse_term(s, pos)
        terms.append(term)
        if pos >= len(s) or s[pos] == ")":
            break
        c = s[pos]
        if c not in "&|":
            raise VisibilityError(f"Expected & or | at {s[pos:]!r}")
        if op is None:
            op = c
        elif op != c:
            raise VisibilityError(
                f"Mixed & and | need parentheses in {s!r} (Accumulo rule)")
        pos += 1
    if len(terms) == 1:
        return terms[0], pos
    return (op, terms), pos


def _parse_term(s: str, pos: int):
    if pos >= len(s):
        raise VisibilityError(f"Unexpected end of visibility {s!r}")
    if s[pos] == "(":
        node, pos = _parse_expr(s, pos + 1)
        if pos >= len(s) or s[pos] != ")":
            raise VisibilityError(f"Unclosed paren in {s!r}")
        return node, pos + 1
    m = _LABEL.match(s, pos)
    if not m:
        raise VisibilityError(f"Bad label at {s[pos:]!r}")
    label = m.group(0)
    if label.startswith('"'):
        label = label[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    return label, m.end()


def evaluate(expr, auths: Iterable[str]) -> bool:
    """AST (or raw string) against an auth set."""
    if isinstance(expr, str):
        expr = parse_visibility(expr)
    if expr is None:
        return True
    auth_set = set(auths)

    def walk(node) -> bool:
        if isinstance(node, str):
            return node in auth_set
        op, children = node
        return (all if op == "&" else any)(walk(c) for c in children)

    return walk(expr)


def allowed_codes(vocab: Sequence[str], auths: Iterable[str]) -> np.ndarray:
    """Dictionary codes of visibility expressions the auths may see — the
    once-per-distinct-expression evaluation that replaces per-row checks."""
    auth_set = set(auths)
    return np.asarray(
        [i for i, expr in enumerate(vocab) if evaluate(expr, auth_set)],
        dtype=np.int32)


class AuthorizationsProvider:
    """Pluggable auth lookup (≙ AuthorizationsProvider SPI; the default
    returns a fixed set, mirroring DefaultAuthorizationsProvider)."""

    def __init__(self, auths: Optional[Sequence[str]] = None):
        self._auths = list(auths or [])

    def get_authorizations(self) -> List[str]:
        return list(self._auths)
