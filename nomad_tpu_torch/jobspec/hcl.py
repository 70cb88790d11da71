"""Minimal HCL reader: the subset jobspecs use.

Supports: ``key = value`` assignments (strings, numbers, booleans, lists),
nested blocks ``name { ... }`` and labeled blocks ``name "label" { ... }``,
and comments (#, //, /* */).  Repeated blocks accumulate into lists.  The
result is a plain dict tree: blocks become ``{"name": [ {..}, ... ]}`` and
labeled blocks carry their label under ``"__label__"``.
"""
from __future__ import annotations

import re
from typing import Any


class HCLError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<punct>[{}\[\],=])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
""", re.VERBOSE | re.DOTALL)

_KEYWORDS = {"true": True, "false": False, "null": None}


def _tokenize(text: str) -> list:
    tokens = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise HCLError(f"line {line}: unexpected character "
                           f"{text[pos]!r}")
        kind = m.lastgroup
        value = m.group()
        line += value.count("\n")
        pos = m.end()
        if kind in ("ws", "comment"):
            continue
        tokens.append((kind, value, line))
    tokens.append(("eof", "", line))
    return tokens


class _Parser:
    def __init__(self, tokens: list) -> None:
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str, value: str = None):
        tok = self.next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise HCLError(
                f"line {tok[2]}: expected {value or kind}, got {tok[1]!r}")
        return tok

    def parse_body(self, out: dict, until: str) -> dict:
        while True:
            kind, value, line = self.peek()
            if kind == "eof" or (kind == "punct" and value == until):
                self.next()
                return out
            if kind not in ("ident", "string"):
                raise HCLError(
                    f"line {line}: expected key or block, got {value!r}")
            self.next()
            key = _unquote(value) if kind == "string" else value

            kind2, value2, line2 = self.peek()
            if kind2 == "punct" and value2 == "=":
                self.next()
                out[key] = self.parse_value()
            elif kind2 == "string":
                # labeled block: name "label" { ... }
                self.next()
                label = _unquote(value2)
                self.expect("punct", "{")
                block = self.parse_body({"__label__": label}, "}")
                out.setdefault(key, []).append(block)
            elif kind2 == "punct" and value2 == "{":
                self.next()
                block = self.parse_body({}, "}")
                out.setdefault(key, []).append(block)
            else:
                raise HCLError(
                    f"line {line2}: expected '=', label or block after "
                    f"{key!r}")

    def parse_value(self) -> Any:
        kind, value, line = self.next()
        if kind == "string":
            return _unquote(value)
        if kind == "number":
            return float(value) if "." in value else int(value)
        if kind == "ident":
            if value in _KEYWORDS:
                return _KEYWORDS[value]
            return value
        if kind == "punct" and value == "[":
            items = []
            while True:
                k, v, ln = self.peek()
                if k == "punct" and v == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
                k, v, ln = self.peek()
                if k == "punct" and v == ",":
                    self.next()
                elif not (k == "punct" and v == "]"):
                    raise HCLError(f"line {ln}: expected ',' or ']' in "
                                   "list")
        raise HCLError(f"line {line}: unexpected value {value!r}")


_ESCAPES = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "r": "\r"}


def _unquote(s: str) -> str:
    # Single pass: sequential .replace() would corrupt a literal
    # backslash followed by 'n'/'t' into a control character.
    return re.sub(r"\\(.)",
                  lambda m: _ESCAPES.get(m.group(1), m.group(0)),
                  s[1:-1])


def loads(text: str) -> dict:
    parser = _Parser(_tokenize(text))
    return parser.parse_body({}, "\x00")
