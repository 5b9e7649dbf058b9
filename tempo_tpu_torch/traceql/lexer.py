"""TraceQL lexer (reference `pkg/traceql/lexer.go`).

Hand-rolled scanner producing a flat token list. Notable behaviors kept from
the reference: scope prefixes (`span.`, `resource.`, `parent.`, `trace:` ...)
lex as single tokens; attribute names after a scope may contain dots; duration
literals (`100ms`, `1h30m` not supported — single unit like reference);
quoted attribute names (`span."http status"`).
"""

from __future__ import annotations

import dataclasses
import enum
import re


class T(enum.Enum):
    EOF = "eof"
    OPEN_BRACE = "{"
    CLOSE_BRACE = "}"
    OPEN_PAREN = "("
    CLOSE_PAREN = ")"
    COMMA = ","
    PIPE = "|"
    DOT = "."
    IDENT = "ident"
    STRING = "string"
    INT = "int"
    FLOAT = "float"
    DURATION = "duration"
    # operators
    EQ = "="
    NEQ = "!="
    REGEX = "=~"
    NOT_REGEX = "!~"
    GT = ">"
    GTE = ">="
    LT = "<"
    LTE = "<="
    AND = "&&"
    OR = "||"
    ADD = "+"
    SUB = "-"
    MULT = "*"
    DIV = "/"
    MOD = "%"
    POW = "^"
    NOT = "!"
    # structural
    DESC = ">>"
    ANCE = "<<"
    TILDE = "~"
    NOT_DESC = "!>>"
    NOT_ANCE = "!<<"
    NOT_CHILD = "!>"
    NOT_PARENT = "!<"
    UNION_CHILD = "&>"
    UNION_PARENT = "&<"
    UNION_DESC = "&>>"
    UNION_ANCE = "&<<"
    UNION_SIBLING = "&~"
    # scopes
    SCOPE = "scope"          # value: "span" | "resource" | "event" | "link" | "instrumentation"
    PARENT_DOT = "parent."
    SCOPE_COLON = "scope:"   # value: "trace" | "span" | "event" | "link" | "instrumentation"


@dataclasses.dataclass
class Token:
    kind: T
    text: str
    pos: int
    value: object = None


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_NUM_RE = re.compile(r"\d+(\.\d+)?")
_IDENT_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_\-]*")
# attribute tail after a scope dot: allow dots, dashes, slashes etc. until an
# operator/space (lexer.go attribute scanning)
_ATTR_RE = re.compile(r'[^\s{}()|,=!<>~&+\-*/%^"]+')

_DUR_SCALE = {"ns": 1, "us": 1_000, "µs": 1_000, "ms": 1_000_000,
              "s": 1_000_000_000, "m": 60_000_000_000, "h": 3_600_000_000_000}

_SCOPES_DOT = ("span", "resource", "event", "link", "instrumentation")
_SCOPES_COLON = ("trace", "span", "event", "link", "instrumentation")

_PUNCT = [  # longest first
    ("!>>", T.NOT_DESC), ("!<<", T.NOT_ANCE), ("&>>", T.UNION_DESC),
    ("&<<", T.UNION_ANCE),
    (">>", T.DESC), ("<<", T.ANCE), ("!>", T.NOT_CHILD), ("!<", T.NOT_PARENT),
    ("&>", T.UNION_CHILD), ("&<", T.UNION_PARENT), ("&~", T.UNION_SIBLING),
    ("!~", T.NOT_REGEX), ("=~", T.REGEX), ("!=", T.NEQ), (">=", T.GTE),
    ("<=", T.LTE), ("&&", T.AND), ("||", T.OR),
    ("{", T.OPEN_BRACE), ("}", T.CLOSE_BRACE), ("(", T.OPEN_PAREN),
    (")", T.CLOSE_PAREN), (",", T.COMMA), ("|", T.PIPE), ("=", T.EQ),
    (">", T.GT), ("<", T.LT), ("+", T.ADD), ("-", T.SUB), ("*", T.MULT),
    ("/", T.DIV), ("%", T.MOD), ("^", T.POW), ("!", T.NOT), ("~", T.TILDE),
    (".", T.DOT),
]


class LexError(ValueError):
    pass


def _string(s: str, i: int) -> tuple[str, int]:
    quote = s[i]
    i += 1
    out = []
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"', "'": "'",
                        "`": "`"}.get(nxt, "\\" + nxt))
            i += 2
            continue
        if c == quote:
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise LexError(f"unterminated string at {i}")


def lex(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c in "\"'`":
            start = i
            val, i = _string(src, i)
            toks.append(Token(T.STRING, src[start:i], start, val))
            continue
        # scope prefixes (must come before ident/punct)
        matched_scope = False
        for sc in _SCOPES_DOT:
            if src.startswith(sc + ".", i):
                toks.append(Token(T.SCOPE, sc, i, sc))
                i += len(sc) + 1
                matched_scope = True
                break
        if matched_scope:
            # next: attribute name (possibly quoted, possibly dotted)
            if i < n and src[i] in "\"'`":
                start = i
                val, i = _string(src, i)
                toks.append(Token(T.IDENT, src[start:i], start, val))
            else:
                m = _ATTR_RE.match(src, i)
                if not m:
                    raise LexError(f"expected attribute name at {i}")
                toks.append(Token(T.IDENT, m.group(0), i, m.group(0)))
                i = m.end()
            continue
        if src.startswith("parent.", i):
            toks.append(Token(T.PARENT_DOT, "parent.", i))
            i += 7
            # a scope prefix (span./resource.) continues via the main loop;
            # otherwise take the raw attribute tail here
            if not any(src.startswith(sc + ".", i) for sc in _SCOPES_DOT):
                if i < n and src[i] in "\"'`":
                    start = i
                    val, i = _string(src, i)
                    toks.append(Token(T.IDENT, src[start:i], start, val))
                else:
                    m = _ATTR_RE.match(src, i)
                    if not m:
                        raise LexError(f"expected attribute after parent. at {i}")
                    toks.append(Token(T.IDENT, m.group(0), i, m.group(0)))
                    i = m.end()
            continue
        for sc in _SCOPES_COLON:
            if src.startswith(sc + ":", i):
                toks.append(Token(T.SCOPE_COLON, sc, i, sc))
                i += len(sc) + 1
                m = _IDENT_RE.match(src, i)
                if not m:
                    raise LexError(f"expected intrinsic name after {sc}: at {i}")
                toks.append(Token(T.IDENT, m.group(0), i, m.group(0)))
                i = m.end()
                matched_scope = True
                break
        if matched_scope:
            continue
        if c.isdigit():
            if _DUR_RE.match(src, i):
                # duration literal, possibly multi-part (1h30m)
                total = 0.0
                j = i
                while True:
                    m2 = _DUR_RE.match(src, j)
                    if not m2:
                        break
                    total += float(m2.group(1)) * _DUR_SCALE[m2.group(2)]
                    j = m2.end()
                toks.append(Token(T.DURATION, src[i:j], i, int(total)))
                i = j
                continue
            m = _NUM_RE.match(src, i)
            text = m.group(0)
            if "." in text:
                toks.append(Token(T.FLOAT, text, i, float(text)))
            else:
                toks.append(Token(T.INT, text, i, int(text)))
            i = m.end()
            continue
        if c == "." and i + 1 < n and src[i + 1].isdigit():
            m = _NUM_RE.match(src, i + 1)
            text = "." + m.group(0)
            toks.append(Token(T.FLOAT, text, i, float(text)))
            i = m.end()
            continue
        if c == "." and i + 1 < n and (src[i + 1].isalpha() or src[i + 1] in '_"\'`'):
            # unscoped attribute `.foo.bar`
            toks.append(Token(T.DOT, ".", i))
            i += 1
            if src[i] in "\"'`":
                start = i
                val, i = _string(src, i)
                toks.append(Token(T.IDENT, src[start:i], start, val))
            else:
                m = _ATTR_RE.match(src, i)
                toks.append(Token(T.IDENT, m.group(0), i, m.group(0)))
                i = m.end()
            continue
        m = _IDENT_RE.match(src, i)
        if m:
            toks.append(Token(T.IDENT, m.group(0), i, m.group(0)))
            i = m.end()
            continue
        for text, kind in _PUNCT:
            if src.startswith(text, i):
                toks.append(Token(kind, text, i))
                i += len(text)
                break
        else:
            raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token(T.EOF, "", n))
    return toks
