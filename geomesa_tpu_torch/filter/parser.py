"""Recursive-descent parser for the ECQL subset the framework accepts.

≙ the reference's use of GeoTools ``ECQL.toFilter``. Grammar:

  expr        := or_expr
  or_expr     := and_expr (OR and_expr)*
  and_expr    := not_expr (AND not_expr)*
  not_expr    := NOT not_expr | '(' expr ')' | predicate
  predicate   := INCLUDE | EXCLUDE
               | BBOX '(' attr ',' num ',' num ',' num ',' num ')'
               | INTERSECTS|CONTAINS|WITHIN '(' attr ',' wkt ')'
               | DWITHIN '(' attr ',' wkt ',' num ',' units ')'
               | ST_CONTAINS|ST_INTERSECTS '(' farg ',' farg ')'
               | ST_AREA|ST_LENGTH|ST_DISTANCE '(' farg* ')' op num
               | attr DURING iso '/' iso
               | attr BETWEEN lit AND lit
               | attr IN '(' lit (',' lit)* ')'
               | IN '(' str (',' str)* ')'          -- fid filter
               | attr IS [NOT] NULL
               | attr ('='|'<>'|'<='|'>='|'<'|'>') lit

Dates parse to int64 epoch millis; strings are single-quoted.

Geometry function calls (≙ geomesa-spark-jts UDFs, case-insensitive):
``farg`` is an attribute, a WKT literal, a number, or a nested geometry
function (st_buffer/st_centroid/st_convexHull). Boolean calls
(st_contains/st_intersects) stand alone as predicates; scalar calls
(st_area/st_length/st_distance) must be compared to a number, e.g.
``st_distance(geom, POINT(10 20)) < 0.5 AND st_contains(POLYGON(..), geom)``.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from geomesa_tpu_torch.features.geometry import parse_wkt
from geomesa_tpu_torch.filter import ir

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\() | (?P<rparen>\)) | (?P<comma>,) |
        (?P<op><=|>=|<>|=|<|>) |
        (?P<string>'(?:[^']|'')*') |
        (?P<datetime>\d{4}-\d{2}-\d{2}T[\d:.]+Z?) |
        (?P<number>-?\d+\.?\d*(?:[eE][+-]?\d+)?) |
        (?P<slash>/) |
        (?P<word>[A-Za-z_][A-Za-z0-9_.:]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "AND", "OR", "NOT", "INCLUDE", "EXCLUDE", "BBOX", "INTERSECTS", "CONTAINS",
    "WITHIN", "DWITHIN", "DURING", "BETWEEN", "IN", "IS", "NULL", "LIKE",
    "POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING",
    "MULTIPOLYGON", "TRUE", "FALSE",
}

_GEOM_WORDS = {"POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING", "MULTIPOLYGON"}


def _parse_dt(s: str) -> int:
    s = s.rstrip("Z")
    return int(np.datetime64(s, "ms").astype(np.int64))


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: List[tuple] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise ValueError(f"Cannot tokenize ECQL at: {text[pos:pos+40]!r}")
                break
            pos = m.end()
            kind = m.lastgroup
            self.toks.append((kind, m.group(kind)))
        self.i = 0

    def peek(self, ahead: int = 0) -> Optional[tuple]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> tuple:
        tok = self.peek()
        if tok is None:
            raise ValueError("Unexpected end of ECQL")
        self.i += 1
        return tok

    def expect(self, kind: str, value: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (value is not None and v.upper() != value):
            raise ValueError(f"Expected {value or kind}, got {v!r} in {self.text!r}")
        return v

    def peek_word(self) -> Optional[str]:
        tok = self.peek()
        return tok[1].upper() if tok and tok[0] == "word" else None


def parse_ecql(text: str) -> ir.Filter:
    if not text or not text.strip():
        return ir.Include()
    toks = _Tokens(text)
    f = _parse_or(toks)
    if toks.peek() is not None:
        raise ValueError(f"Trailing input in ECQL: {toks.peek()}")
    return f


def _parse_or(toks: _Tokens) -> ir.Filter:
    parts = [_parse_and(toks)]
    while toks.peek_word() == "OR":
        toks.next()
        parts.append(_parse_and(toks))
    return parts[0] if len(parts) == 1 else ir.Or(parts)


def _parse_and(toks: _Tokens) -> ir.Filter:
    parts = [_parse_not(toks)]
    while toks.peek_word() == "AND":
        toks.next()
        parts.append(_parse_not(toks))
    return parts[0] if len(parts) == 1 else ir.And(parts)


def _parse_not(toks: _Tokens) -> ir.Filter:
    if toks.peek_word() == "NOT":
        toks.next()
        return ir.Not(_parse_not(toks))
    tok = toks.peek()
    if tok and tok[0] == "lparen":
        # could be a parenthesized expression
        toks.next()
        f = _parse_or(toks)
        toks.expect("rparen")
        return f
    return _parse_predicate(toks)


def _parse_wkt_literal(toks: _Tokens) -> tuple:
    word = toks.expect("word").upper()
    if word not in _GEOM_WORDS:
        raise ValueError(f"Expected geometry literal, got {word}")
    # re-assemble the parenthesized coordinate text
    depth = 0
    parts = [word]
    while True:
        k, v = toks.next()
        if k == "lparen":
            depth += 1
            parts.append("(")
        elif k == "rparen":
            depth -= 1
            parts.append(")")
            if depth == 0:
                break
        elif k == "comma":
            parts.append(",")
        else:
            parts.append(" " + v + " ")
    return parse_wkt("".join(parts))


def _parse_literal(toks: _Tokens):
    k, v = toks.next()
    if k == "string":
        return v[1:-1].replace("''", "'")
    if k == "number":
        return float(v) if ("." in v or "e" in v or "E" in v) else int(v)
    if k == "datetime":
        return _parse_dt(v)
    if k == "word" and v.upper() in ("TRUE", "FALSE"):
        return v.upper() == "TRUE"
    raise ValueError(f"Expected literal, got {v!r}")


def _parse_func_args(toks: _Tokens) -> tuple:
    """Comma-separated function arguments inside (already-consumed) parens:
    attribute names, WKT literals, numbers, or nested st_* calls."""
    toks.expect("lparen")
    args = []
    while True:
        tok = toks.peek()
        if tok is None:
            raise ValueError("Unterminated function call")
        k, v = tok
        if k == "word" and v.upper() in _GEOM_WORDS:
            args.append(_parse_wkt_literal(toks))
        elif k == "word" and v.lower() in ir.FUNC_NAMES:
            name = v.lower()
            if name not in ir.FUNC_GEOM:
                raise ValueError(
                    f"{v} does not return a geometry; only "
                    "st_buffer/st_centroid/st_convexHull nest")
            toks.next()
            args.append(ir.FuncExpr(name, _parse_func_args(toks)))
        elif k == "word":
            args.append(toks.next()[1])   # attribute reference
        elif k == "number":
            args.append(float(toks.next()[1]))
        else:
            raise ValueError(f"Bad function argument {v!r}")
        k2, _ = toks.next()
        if k2 == "rparen":
            return tuple(args)
        if k2 != "comma":
            raise ValueError(f"Expected ',' or ')' in function call, got {k2}")


def _parse_func_predicate(toks: _Tokens) -> ir.Filter:
    name = toks.expect("word").lower()
    args = _parse_func_args(toks)
    nxt = toks.peek()
    if nxt is not None and nxt[0] == "op":
        op = toks.next()[1]
        val = _parse_literal(toks)
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            raise ValueError(f"{name} compares to a number, got {val!r}")
        if name not in ir.FUNC_SCALAR:
            raise ValueError(f"{name} is not numeric; only "
                             "st_area/st_length/st_distance compare")
        return ir.FuncCmp(op, name, args, float(val))
    if name in ir.FUNC_BOOLEAN:
        return ir.Func(name, args)
    raise ValueError(
        f"{name} is not a boolean predicate: compare it to a value "
        "(e.g. st_distance(geom, POINT(0 0)) < 1)")


def _parse_predicate(toks: _Tokens) -> ir.Filter:
    word = toks.peek_word()
    if word is None:
        raise ValueError(f"Expected predicate at token {toks.peek()}")

    if word == "INCLUDE":
        toks.next()
        return ir.Include()
    if word == "EXCLUDE":
        toks.next()
        return ir.Exclude()

    if word == "BBOX":
        toks.next()
        toks.expect("lparen")
        attr = toks.expect("word")
        vals = []
        for _ in range(4):
            toks.expect("comma")
            vals.append(float(toks.expect("number")))
        # optional trailing CRS argument
        if toks.peek() and toks.peek()[0] == "comma":
            toks.next()
            toks.next()
        toks.expect("rparen")
        return ir.BBox(attr, *vals)

    if word in ("INTERSECTS", "CONTAINS", "WITHIN"):
        toks.next()
        toks.expect("lparen")
        attr = toks.expect("word")
        toks.expect("comma")
        geom = _parse_wkt_literal(toks)
        toks.expect("rparen")
        cls = {"INTERSECTS": ir.Intersects, "CONTAINS": ir.Contains, "WITHIN": ir.Within}[word]
        return cls(attr, geom)

    if word == "DWITHIN":
        toks.next()
        toks.expect("lparen")
        attr = toks.expect("word")
        toks.expect("comma")
        geom = _parse_wkt_literal(toks)
        toks.expect("comma")
        dist = float(toks.expect("number"))
        if toks.peek() and toks.peek()[0] == "comma":  # units word (ignored: degrees)
            toks.next()
            toks.next()
        toks.expect("rparen")
        return ir.Dwithin(attr, geom, dist)

    if word.lower() in ir.FUNC_NAMES:
        return _parse_func_predicate(toks)

    if word == "IN":
        # bare IN(...) = feature-id filter
        toks.next()
        toks.expect("lparen")
        fids = [str(_parse_literal(toks))]
        while toks.peek() and toks.peek()[0] == "comma":
            toks.next()
            fids.append(str(_parse_literal(toks)))
        toks.expect("rparen")
        return ir.FidFilter(tuple(fids))

    # attribute-led predicates
    attr = toks.expect("word")
    nxt = toks.peek()
    if nxt is None:
        raise ValueError(f"Dangling attribute {attr!r}")

    if nxt[0] == "word":
        kw = nxt[1].upper()
        if kw == "DURING":
            toks.next()
            lo = _parse_dt(toks.expect("datetime"))
            toks.expect("slash")
            hi = _parse_dt(toks.expect("datetime"))
            return ir.During(attr, lo, hi)
        if kw == "BETWEEN":
            toks.next()
            lo = _parse_literal(toks)
            toks.expect("word", "AND")
            hi = _parse_literal(toks)
            if isinstance(lo, int) and isinstance(hi, int) and abs(hi) > 10**11:
                return ir.During(attr, lo, hi, True, True)
            return ir.And([ir.Cmp(">=", attr, lo), ir.Cmp("<=", attr, hi)])
        if kw == "IN":
            toks.next()
            toks.expect("lparen")
            vals = [_parse_literal(toks)]
            while toks.peek() and toks.peek()[0] == "comma":
                toks.next()
                vals.append(_parse_literal(toks))
            toks.expect("rparen")
            return ir.In(attr, tuple(vals))
        if kw == "IS":
            toks.next()
            negate = False
            if toks.peek_word() == "NOT":
                toks.next()
                negate = True
            toks.expect("word", "NULL")
            f: ir.Filter = ir.IsNull(attr)
            return ir.Not(f) if negate else f
        raise ValueError(f"Unsupported predicate keyword {kw!r}")

    if nxt[0] == "op":
        op = toks.next()[1]
        val = _parse_literal(toks)
        return ir.Cmp(op, attr, val)

    raise ValueError(f"Cannot parse predicate after {attr!r}: {nxt}")
