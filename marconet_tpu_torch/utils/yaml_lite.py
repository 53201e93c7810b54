"""A reader for the YAML subset of the training configs, without PyYAML.

The card's machine has no ``yaml`` module, so the port reads
``options/train.yml`` (and configs like it) with this reader. For the
documents it accepts it returns what ``yaml.safe_load`` returns:

* block mappings and block sequences (``- item``, also ``- key: value``
  items), nested by indentation;
* flow mappings and sequences on one line (``{type: Adam, lr: 1.0}``,
  ``[600000, 700000]``), nested;
* comments (``#`` at the start of a line or after a space), blank lines;
* scalars resolved as YAML 1.1 / PyYAML resolves them: ``~``, ``null`` and
  an empty value as None; ``true`` / ``false`` / ``yes`` / ``no`` / ``on``
  / ``off`` (in PyYAML's three spellings) as booleans; decimal integers
  (``_`` allowed); floats of PyYAML's pattern (a ``.`` is required and an
  exponent needs its sign, so ``1e-5`` stays a string), ``.inf``,
  ``.nan``; the ``!!float`` tag; single- and double-quoted strings; any
  other plain scalar as a string.

Anything else raises :class:`YamlError` naming the line: anchors and
aliases, block scalars (``|``, ``>``), multi-line plain scalars and flow
collections, other tags, directives and document markers, tabs in the
indentation, and the integer forms PyYAML would read as numbers but this
reader does not (hexadecimal, binary, octal, sexagesimal).
"""

from __future__ import annotations

import math
import re
from typing import Any, List, NamedTuple, Optional, Tuple

_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
                  ".nan": math.nan}
# numbers PyYAML resolves that this reader does not
_OTHER_NUMBER = re.compile(
    r"[-+]?0[box]|[-+]?0[0-9_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\",
            '"': '"', "/": "/", " ": " "}


class YamlError(ValueError):
    """A document outside the supported subset, or malformed."""


class _Line(NamedTuple):
    number: int      # 1-based
    indent: int
    text: str        # without indentation and comment


def _strip_comment(text: str) -> str:
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _lines(doc: str, name: str) -> List[_Line]:
    out = []
    for number, raw in enumerate(doc.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlError(f"{name}:{number}: tab in the indentation")
        text = _strip_comment(body)
        if not text:
            continue
        if text.startswith(("%", "---", "...")):
            raise YamlError(f"{name}:{number}: directives and document "
                            f"markers are not supported: {text!r}")
        out.append(_Line(number, len(raw) - len(body), text))
    return out


def _resolve_plain(text: str, where: str) -> Any:
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text.lower()]
    if _OTHER_NUMBER.match(text):
        raise YamlError(f"{where}: number form not supported: {text!r}")
    if text[0] in "&*!|>@`%":
        raise YamlError(f"{where}: not supported: {text!r} (anchors, "
                        "aliases, tags other than !!float and block "
                        "scalars are outside the subset)")
    return text


def _to_float(value: Any, text: str, where: str) -> float:
    """The ``!!float`` tag (PyYAML's ``construct_yaml_float``)."""
    if isinstance(value, str) or value is None:
        s = (text or "").replace("_", "").lower()
        if s in _SPECIAL_FLOAT:
            return _SPECIAL_FLOAT[s]
        try:
            return float(s)
        except ValueError:
            raise YamlError(f"{where}: !!float of {text!r}") from None
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise YamlError(f"{where}: !!float of {text!r}")
    return float(value)


class _Flow:
    """One line's flow collection or scalar, parsed left to right."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str) -> YamlError:
        return YamlError(f"{self.where}: {msg} in {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def value(self, flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        if self.s.startswith("!!float", self.i):
            self.i += len("!!float")
            start = self.i
            value = self.value(flow)
            return _to_float(value, self.s[start:self.i].strip(), self.where)
        return self.plain(flow)

    def plain(self, flow: bool) -> Any:
        start = self.i
        stops = ",[]{}" if flow else ""
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] == " "
                              or (flow and self.s[self.i + 1] in ",}]")):
                break
            self.i += 1
        return _resolve_plain(self.s[start:self.i].strip(), self.where)

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch == q:
                if q == "'" and self.s.startswith("''", self.i):
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc not in _ESCAPES:
                    raise self.error(f"escape \\{esc} not supported")
                out.append(_ESCAPES[esc])
                self.i += 2
                continue
            out.append(ch)
            self.i += 1
        raise self.error("unterminated quoted scalar (multi-line scalars "
                         "are not supported)")

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "]":
                self.i += 1
                return out
            if not ch:
                raise self.error("flow sequence not closed on its line")
            out.append(self.value(flow=True))
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise self.error(f"expected , or ] at column {self.i}")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            ch = self.peek()
            if ch == "}":
                self.i += 1
                return out
            if not ch:
                raise self.error("flow mapping not closed on its line")
            key = self.value(flow=True)
            value = None
            if self.peek() == ":":
                self.i += 1
                if self.peek() not in (",", "}"):
                    value = self.value(flow=True)
            out[key] = value
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise self.error(f"expected , or }} at column {self.i}")

    def whole(self) -> Any:
        value = self.value(flow=False)
        if self.peek():
            raise self.error("unexpected text after the value")
        return value


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """``key: value`` / ``key:`` -> (key, value text), else None."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{" and i == 0:
            return None
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].strip(), text[i + 1:].strip()
    return None


class _Parser:
    def __init__(self, lines: List[_Line], name: str):
        self.lines, self.name, self.i = lines, name, 0

    def where(self, line: _Line) -> str:
        return f"{self.name}:{line.number}"

    def inline(self, text: str, line: _Line) -> Any:
        return _Flow(text, self.where(line)).whole()

    def block(self, indent: int) -> Any:
        line = self.lines[self.i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if _split_key(line.text) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self.inline(line.text, line)

    def child(self, parent: _Line, allow_same_indent_seq: bool) -> Any:
        """The nested block after ``key:`` / ``-`` with nothing after it."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > parent.indent or (
                    allow_same_indent_seq and nxt.indent == parent.indent
                    and (nxt.text == "-" or nxt.text.startswith("- "))):
                return self.block(nxt.indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise YamlError(f"{self.where(line)}: unexpected indentation"
                                " (multi-line scalars are not supported)")
            split = _split_key(line.text)
            if split is None:
                if line.text == "-" or line.text.startswith("- "):
                    break
                raise YamlError(f"{self.where(line)}: expected 'key: value',"
                                f" got {line.text!r}")
            key_text, value_text = split
            key = self.inline(key_text, line)
            self.i += 1
            if value_text:
                out[key] = self.inline(value_text, line)
            else:
                out[key] = self.child(line, allow_same_indent_seq=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or not (
                    line.text == "-" or line.text.startswith("- ")):
                if line.indent > indent:
                    raise YamlError(f"{self.where(line)}: unexpected "
                                    "indentation")
                break
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.child(line, allow_same_indent_seq=False))
                continue
            # the item's text as a line of its own, indented under the dash
            self.lines[self.i] = _Line(
                line.number, indent + len(line.text) - len(rest), rest)
            out.append(self.block(self.lines[self.i].indent))
        return out


def loads(doc: str, name: str = "<string>") -> Any:
    """Parse one document of the subset; ``yaml.safe_load`` semantics."""
    lines = _lines(doc, name)
    if not lines:
        return None
    parser = _Parser(lines, name)
    value = parser.block(lines[0].indent)
    if parser.i < len(lines):
        line = lines[parser.i]
        raise YamlError(f"{name}:{line.number}: unexpected {line.text!r}")
    return value


def load(path: str) -> Any:
    """Parse the YAML file at ``path`` (see :func:`loads`)."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), path)
