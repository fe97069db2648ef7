"""A reader and a writer for the YAML that the config files and their
snapshots use, so the port needs no PyYAML.

The subset: block mappings and block lists (indented or at the key's
indentation), compact list items (`- key: value`), flow lists and maps
(`[]`, `{}`, `[a, b]`, `{embed_dim: 192, depth: 12}`, nested), plain,
single- and double-quoted scalars (a plain scalar may continue on more
indented lines), `#` comments and a leading `---`. Plain scalars resolve
as PyYAML's `safe_load` resolves them (YAML 1.1: `yes`/`off` are booleans,
`1e-3` without a dot is a string, `0o17`-style octals are `0` prefixed).
Anchors, aliases, tags and block scalars (`|`, `>`) raise.

`dump` writes block style that both this reader and PyYAML read back to
the same tree; floats are written as PyYAML writes them.
"""

from __future__ import annotations

import math
import re
from typing import Any

__all__ = ["load", "dump", "YAMLSubsetError"]


class YAMLSubsetError(ValueError):
    pass


# ---- plain-scalar resolution: PyYAML's implicit resolvers (YAML 1.1) ----

_BOOL = {
    "yes": True, "Yes": True, "YES": True, "true": True, "True": True,
    "TRUE": True, "on": True, "On": True, "ON": True,
    "no": False, "No": False, "NO": False, "false": False, "False": False,
    "FALSE": False, "off": False, "Off": False, "OFF": False,
}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT_RE = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _to_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's `safe_load` gives it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        return _to_int(text)
    if _FLOAT_RE.match(text):
        return _to_float(text)
    return text


# ---- quoted scalars ----

_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
    "P": "\u2029",
}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _read_quoted(text: str, pos: int) -> tuple[str, int]:
    """The quoted scalar starting at text[pos]; returns (value, end)."""
    quote = text[pos]
    out: list[str] = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if ch == "\n":
            i = _fold(text, i, out)
            continue
        if quote == "'":
            if ch == "'":
                if text.startswith("''", i):
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            code = text[i + 1 : i + 2]
            if code == "\n":  # an escaped line break joins the lines
                i += 2
                while i < len(text) and text[i] in " \t":
                    i += 1
                continue
            if code in _HEX_LEN:
                n = _HEX_LEN[code]
                out.append(chr(int(text[i + 2 : i + 2 + n], 16)))
                i += 2 + n
                continue
            if code not in _ESCAPES:
                raise YAMLSubsetError(f"unknown escape \\{code} in {text!r}")
            out.append(_ESCAPES[code])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"unterminated quoted scalar in {text!r}")


def _fold(text: str, i: int, out: list[str]) -> int:
    """Fold the line breaks starting at text[i] into `out`: one break is a
    space, n + 1 breaks (n empty lines) are n newlines. Returns the index
    after the breaks and the next line's indentation."""
    while out and out[-1] in " \t":
        out.pop()
    breaks = 0
    while i < len(text) and text[i] in " \t\n":
        breaks += text[i] == "\n"
        i += 1
    out.append(" " if breaks == 1 else "\n" * (breaks - 1))
    return i


# ---- flow collections and inline values ----

_UNSUPPORTED_START = "&*!|>%@`"


def _skip_ws(text: str, pos: int) -> int:
    while pos < len(text) and text[pos] in " \t\n":
        pos += 1
    return pos


def _flow_plain(text: str, pos: int) -> tuple[str, int]:
    """A plain scalar inside a flow collection: up to `,`, `]`, `}` or a
    `:` followed by a space or a flow indicator."""
    start = pos
    while pos < len(text):
        ch = text[pos]
        if ch in ",]}":
            break
        if ch == ":" and (pos + 1 == len(text) or text[pos + 1] in " \t\n,]}"):
            break
        pos += 1
    return " ".join(text[start:pos].split()), pos


def _flow_node(text: str, pos: int) -> tuple[Any, int]:
    pos = _skip_ws(text, pos)
    if pos >= len(text):
        raise YAMLSubsetError(f"flow collection ends early: {text!r}")
    ch = text[pos]
    if ch == "[":
        items: list = []
        pos = _skip_ws(text, pos + 1)
        while text[pos] != "]":
            item, pos = _flow_node(text, pos)
            items.append(item)
            pos = _skip_ws(text, pos)
            if text[pos] == ",":
                pos = _skip_ws(text, pos + 1)
            elif text[pos] != "]":
                raise YAMLSubsetError(f"expected , or ] in {text!r}")
        return items, pos + 1
    if ch == "{":
        mapping: dict = {}
        pos = _skip_ws(text, pos + 1)
        while text[pos] != "}":
            key, pos = _flow_node(text, pos)
            pos = _skip_ws(text, pos)
            value = None
            if text[pos] == ":":
                pos = _skip_ws(text, pos + 1)
                if text[pos] not in ",}":
                    value, pos = _flow_node(text, pos)
                    pos = _skip_ws(text, pos)
            mapping[key] = value
            if text[pos] == ",":
                pos = _skip_ws(text, pos + 1)
            elif text[pos] != "}":
                raise YAMLSubsetError(f"expected , or }} in {text!r}")
        return mapping, pos + 1
    if ch in "'\"":
        return _read_quoted(text, pos)
    if ch in _UNSUPPORTED_START:
        raise YAMLSubsetError(f"unsupported YAML construct in {text!r}")
    raw, pos = _flow_plain(text, pos)
    return resolve_plain(raw), pos


def _inline_value(text: str) -> Any:
    """A value written after `key:` or `- ` (continuation lines joined
    with newlines)."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "[{":
        value, end = _flow_node(text, 0)
    elif text[0] in "'\"":
        value, end = _read_quoted(text, 0)
    elif text[0] in _UNSUPPORTED_START:
        raise YAMLSubsetError(f"unsupported YAML construct: {text!r}")
    else:
        out: list[str] = []
        i = 0
        while i < len(text):
            if text[i] == "\n":
                i = _fold(text, i, out)
            else:
                out.append(text[i])
                i += 1
        return resolve_plain("".join(out))
    if text[end:].strip():
        raise YAMLSubsetError(f"trailing text after a value: {text!r}")
    return value


# ---- block structure ----


def _strip_comment(line: str) -> str:
    """The line without its `#` comment; quotes open only at the start of
    a scalar (after the line start, `: `, `- `, `[`, `{` or `,`)."""
    quote = None
    prev = " "
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote:
                if quote == "'" and line.startswith("''", i):
                    i += 2
                    continue
                quote = None
            elif quote == '"' and ch == "\\":
                i += 2
                continue
        elif ch in "'\"" and prev in " \t[{,:-":
            quote = ch
        elif ch == "#" and prev in " \t":
            return line[:i].rstrip()
        prev = ch
        i += 1
    return line.rstrip()


class _Line:
    __slots__ = ("indent", "text", "blanks")

    def __init__(self, indent: int, text: str, blanks: int = 0):
        # blanks: the empty lines before this one (they fold into newlines
        # inside a multi-line scalar)
        self.indent, self.text, self.blanks = indent, text, blanks


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str) -> tuple[str, str] | None:
    """(key, rest) when `text` starts a mapping entry, else None."""
    if text[0] in "'\"":
        try:
            key, end = _read_quoted(text, 0)
        except YAMLSubsetError:
            return None
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:]
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?=\s|$)", text)
    return (text[: m.start()].rstrip(), text[m.end() :]) if m else None


class _Parser:
    def __init__(self, text: str):
        self.lines: list[_Line] = []
        blanks = 0
        for raw in text.replace("\r\n", "\n").split("\n"):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLSubsetError("tabs in indentation")
            body = _strip_comment(raw)
            stripped = body.strip()
            if not stripped:
                blanks += not raw.strip()
                continue
            if not self.lines and stripped == "---":
                continue
            if stripped in ("---", "...") or stripped.startswith("%"):
                raise YAMLSubsetError(f"unsupported line: {raw!r}")
            indent = len(body) - len(body.lstrip(" "))
            self.lines.append(_Line(indent, stripped, blanks))
            blanks = 0
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        node = self._block(self.lines[0].indent)
        if self.i != len(self.lines):
            line = self.lines[self.i]
            raise YAMLSubsetError(f"unexpected indentation at {line.text!r}")
        return node

    def _continuation(self, indent: int, first: str) -> str:
        """`first` plus the following lines indented more than `indent`
        that continue it (a multi-line scalar or flow collection)."""
        parts = [first]
        while self.i < len(self.lines) and self.lines[self.i].indent > indent:
            line = self.lines[self.i]
            parts.append("\n" * (1 + line.blanks) + line.text)
            self.i += 1
        return "".join(parts)

    def _block(self, indent: int) -> Any:
        line = self.lines[self.i]
        if _is_item(line.text):
            return self._sequence(line.indent)
        if _split_key(line.text) is not None:
            return self._mapping(line.indent)
        self.i += 1
        return _inline_value(self._continuation(indent - 1, line.text))

    def _nested(self, indent: int) -> Any:
        """The block value of an entry whose inline value is empty."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self._block(nxt.indent)
            if nxt.indent == indent and _is_item(nxt.text):
                return self._sequence(indent)  # indentless list
        return None

    def _mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or _is_item(line.text):
                break
            split = _split_key(line.text)
            if split is None:
                raise YAMLSubsetError(f"expected a mapping key at {line.text!r}")
            key, rest = split
            key = resolve_plain(key) if line.text[0] not in "'\"" else key
            if key in out:
                raise YAMLSubsetError(f"duplicate key {key!r}")
            self.i += 1
            rest = rest.strip()
            if rest:
                out[key] = _inline_value(self._continuation(indent, rest))
            else:
                out[key] = self._nested(indent)
        return out

    def _sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent != indent or not _is_item(line.text):
                break
            rest = line.text[1:]
            if not rest.strip():
                self.i += 1
                out.append(self._nested(indent))
                continue
            offset = len(rest) - len(rest.lstrip(" "))
            rest = rest.lstrip(" ")
            if _is_item(rest) or _split_key(rest) is not None:
                # a compact nested node: re-read the rest of the line as
                # the first line of a block at its own column
                self.lines[self.i] = _Line(indent + 1 + offset, rest)
                out.append(self._block(indent + 1 + offset))
            else:
                self.i += 1
                out.append(_inline_value(self._continuation(indent, rest)))
        return out


def load(text: str) -> Any:
    """Parse a YAML document of the subset (see the module docstring)."""
    return _Parser(text).parse()


# ---- writer ----

_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+=()-]*$")


def _float_text(value: float) -> str:
    if value != value:
        return ".nan"
    if value == math.inf:
        return ".inf"
    if value == -math.inf:
        return "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float_text(value)
    if not isinstance(value, str):
        raise YAMLSubsetError(f"cannot write a {type(value).__name__}")
    if _SAFE_PLAIN.match(value) and resolve_plain(value) == value:
        return value
    if value.isprintable():
        return "'" + value.replace("'", "''") + "'"
    out = []
    for ch in value:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch.isprintable():
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02x}")
        else:
            out.append(f"\\u{ord(ch):04x}" if ord(ch) <= 0xFFFF else f"\\U{ord(ch):08x}")
    return '"' + "".join(out) + '"'


def _dump_node(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(item, dict) and item:
                out.append(head)
                _dump_node(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(head)
                _dump_node(list(item), indent + 2, out)
            else:
                out.append(f"{head} {_inline_text(item)}")
        return
    for item in value:
        if isinstance(item, (dict, list, tuple)) and item:
            out.append(f"{pad}-")
            _dump_node(item if isinstance(item, dict) else list(item), indent + 2, out)
        else:
            out.append(f"{pad}- {_inline_text(item)}")


def _inline_text(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_text(value)


def dump(tree: Any) -> str:
    """Block-style YAML for a tree of dicts, lists and scalars."""
    if isinstance(tree, (dict, list, tuple)) and tree:
        out: list[str] = []
        _dump_node(tree if isinstance(tree, dict) else list(tree), 0, out)
        return "\n".join(out) + "\n"
    return _inline_text(tree) + "\n"
