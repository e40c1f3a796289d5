"""A reader for the YAML the repository's configs use, on the stdlib alone.

The card has no PyYAML.  ``load`` returns what ``yaml.safe_load`` returns for
the subset below; anything outside it raises ``YAMLSubsetError`` naming the
line.

- block mappings and block sequences by indentation (``key: value``,
  ``- item``, a sequence at its key's indentation, ``- key: value`` items);
- flow sequences on one line (``["train"]``, nested ones too);
- plain, single-quoted and double-quoted scalars on one line, ``#`` comments
  and empty values;
- YAML 1.1 scalar types exactly as PyYAML's resolver types them: ``True``,
  ``on`` and ``yes`` are bools, ``null`` and ``~`` None, ``017`` octal,
  ``1_000`` an int, ``1.0e-4`` a float and ``1e-4`` a string (the float
  pattern needs a dot and a signed exponent).

Outside it: anchors, aliases, tags, block scalars (``|``, ``>``), flow
mappings, multi-line scalars, complex keys, merge keys, timestamps,
directives and document markers.
"""

from __future__ import annotations

import re
from typing import Any, List, NamedTuple, Tuple


class YAMLSubsetError(ValueError):
    """Malformed YAML, or YAML outside the subset this reader takes."""


class _Line(NamedTuple):
    number: int  # 1-based, for messages
    indent: int
    text: str  # without the indentation; may end in a comment


# PyYAML's implicit resolvers (yaml/resolver.py), in the order it tries them
_RESOLVERS = (
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                        |[-+]?0[0-7_]+
                        |[-+]?(?:0|[1-9][0-9_]*)
                        |[-+]?0x[0-9a-fA-F_]+
                        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("merge key", re.compile(r"^(?:<<)$")),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$")),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("value key", re.compile(r"^(?:=)$")),
)
_BOOLS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these (PyYAML's scanner, check_plain)
_NOT_PLAIN = {
    "&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
    ">": "a block scalar", "{": "a flow mapping", "%": "a directive",
    "@": "a reserved indicator", "`": "a reserved indicator", ",": "a stray ','",
    "]": "a stray ']'", "}": "a stray '}'", "#": "a comment",
}


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _resolve(text: str, line: int) -> Any:
    """A plain scalar typed as PyYAML's SafeLoader types it."""
    for kind, pattern in _RESOLVERS:
        if pattern.match(text):
            if kind == "bool":
                return _BOOLS[text.lower()]
            if kind == "float":
                return _float(text)
            if kind == "int":
                return _int(text)
            if kind == "null":
                return None
            raise YAMLSubsetError(f"line {line}: {kind} {text!r} is outside the subset")
    return text


def _quoted(text: str, pos: int, line: int) -> Tuple[str, int]:
    """The quoted scalar opening at ``text[pos]`` and the index past it."""
    quote, out, i = text[pos], [], pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            code = text[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
                continue
            if code in _ESCAPE_CODES:
                digits = text[i + 2:i + 2 + _ESCAPE_CODES[code]]
                if len(digits) != _ESCAPE_CODES[code] or not all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    raise YAMLSubsetError(f"line {line}: bad escape \\{code}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + len(digits)
                continue
            if code == "":
                raise YAMLSubsetError(f"line {line}: a quoted scalar over several lines "
                                      "is outside the subset")
            raise YAMLSubsetError(f"line {line}: unknown escape \\{code}")
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"line {line}: a quoted scalar over several lines is outside "
                          "the subset")


def _end_of_node(text: str, pos: int, line: int, after_quote: bool = False) -> None:
    """Only blanks and a comment may follow a node."""
    rest = text[pos:]
    if not rest.strip():
        return
    stripped = rest.lstrip(" \t")
    if stripped.startswith("#") and (after_quote or len(stripped) < len(rest)):
        return
    raise YAMLSubsetError(f"line {line}: unexpected {rest.strip()!r} after a value")


def _refuse_indicator(text: str, line: int) -> None:
    ch, nxt = text[0], text[1:2]
    if ch in _NOT_PLAIN:
        raise YAMLSubsetError(f"line {line}: {_NOT_PLAIN[ch]} ({text!r}) is outside the subset")
    if ch in "?:-" and nxt in ("", " ", "\t"):
        what = {"?": "a complex key", ":": "a value without a key", "-": "a sequence entry"}
        raise YAMLSubsetError(f"line {line}: {what[ch]} here ({text!r}) is outside the subset")


def _flow_sequence(text: str, pos: int, line: int) -> Tuple[list, int]:
    """The flow sequence opening at ``text[pos]`` (one line) and the index past it."""
    items, i = [], pos + 1
    while True:
        while i < len(text) and text[i] in " \t":
            i += 1
        if i >= len(text):
            raise YAMLSubsetError(f"line {line}: a flow sequence over several lines is "
                                  "outside the subset")
        if text[i] == "]":
            return items, i + 1
        if text[i] == "[":
            item, i = _flow_sequence(text, i, line)
        elif text[i] in "'\"":
            item, i = _quoted(text, i, line)
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                if text[j] == "#" and text[j - 1] in " \t":
                    break
                j += 1
            plain = text[i:j].strip()
            if not plain:
                raise YAMLSubsetError(f"line {line}: empty entry in a flow sequence")
            _refuse_indicator(plain, line)
            if ": " in plain or plain.endswith(":"):
                raise YAMLSubsetError(f"line {line}: a mapping inside a flow sequence is "
                                      "outside the subset")
            item, i = _resolve(plain, line), j
        items.append(item)
        while i < len(text) and text[i] in " \t":
            i += 1
        if text[i:i + 1] == ",":
            i += 1
        elif text[i:i + 1] != "]":
            raise YAMLSubsetError(f"line {line}: expected ',' or ']' in a flow sequence")


def _value(text: str, line: int) -> Any:
    """A scalar or flow sequence making up the rest of a line."""
    text = text.strip(" \t")
    if text[0] in "'\"":
        value, end = _quoted(text, 0, line)
        _end_of_node(text, end, line, after_quote=True)
        return value
    if text[0] == "[":
        value, end = _flow_sequence(text, 0, line)
        _end_of_node(text, end, line)
        return value
    _refuse_indicator(text, line)
    comment = re.search(r"[ \t]#", text)
    if comment:
        text = text[:comment.start()]
    text = text.rstrip(" \t")
    if re.search(r":(?:[ \t]|$)", text):
        raise YAMLSubsetError(f"line {line}: a mapping value is not allowed here")
    return _resolve(text, line)


def _split_key(text: str, line: int):
    """(key, rest) when ``text`` is a ``key: value`` entry, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, line)
        rest = text[end:].lstrip(" \t")
        if rest[:1] == ":" and rest[1:2] in ("", " ", "\t"):
            return key, rest[1:]
        return None
    comment = re.search(r"[ \t]#", text)
    head = text[:comment.start()] if comment else text
    colon = re.search(r":(?:[ \t]|$)", head)
    if colon is None:
        return None
    key = head[:colon.start()].rstrip(" \t")
    if not key:
        return None
    if key[0] == "[":
        raise YAMLSubsetError(f"line {line}: a flow sequence as a key is outside the subset")
    _refuse_indicator(key, line)
    return _resolve(key, line), text[colon.start() + 1:]


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


def _empty(text: str) -> bool:
    text = text.strip(" \t")
    return not text or text.startswith("#")


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines

    def at(self, i: int, indent: int) -> bool:
        return i < len(self.lines) and self.lines[i].indent == indent

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if _is_entry(line.text):
            return self.sequence(i, indent)
        if _split_key(line.text, line.number) is not None:
            return self.mapping(i, indent)
        value = _value(line.text, line.number)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent >= indent:
            raise YAMLSubsetError(f"line {self.lines[i + 1].number}: a scalar over several "
                                  "lines is outside the subset")
        return value, i + 1

    def nested(self, i: int, indent: int) -> Tuple[Any, int]:
        """The value of an entry whose line ends after ':' or '-': a block
        below it, or None."""
        if i < len(self.lines) and self.lines[i].indent > indent:
            return self.block(i, self.lines[i].indent)
        return None, i

    def inline(self, i: int, indent: int, text: str) -> Tuple[Any, int]:
        """The value that follows ':' or '- ' on line ``i``."""
        line = self.lines[i]
        if _empty(text):
            return self.nested(i + 1, indent)
        value = _value(text, line.number)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
            raise YAMLSubsetError(f"line {self.lines[i + 1].number}: a scalar over several "
                                  "lines is outside the subset")
        return value, i + 1

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while self.at(i, indent):
            line = self.lines[i]
            if _is_entry(line.text):
                raise YAMLSubsetError(f"line {line.number}: a sequence entry inside a mapping")
            split = _split_key(line.text, line.number)
            if split is None:
                raise YAMLSubsetError(f"line {line.number}: expected 'key: value', got "
                                      f"{line.text!r}")
            key, rest = split
            if _empty(rest) and i + 1 < len(self.lines) and self.at(i + 1, indent) \
                    and _is_entry(self.lines[i + 1].text):
                value, i = self.sequence(i + 1, indent)  # a sequence at its key's indent
            else:
                value, i = self.inline(i, indent, rest)
            out[key] = value
        self._dedent(i, indent)
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while self.at(i, indent) and _is_entry(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:]
            item_indent = indent + 1 + len(rest) - len(rest.lstrip(" \t"))
            rest = rest.lstrip(" \t")
            if rest and not _empty(rest) and (_is_entry(rest) or
                                              _split_key(rest, line.number) is not None):
                # "- key: value" or "- - item": a block that opens on this line
                self.lines[i] = _Line(line.number, item_indent, rest)
                item, i = self.block(i, item_indent)
            else:
                item, i = self.inline(i, indent, rest)
            out.append(item)
        self._dedent(i, indent)
        return out, i

    def _dedent(self, i: int, indent: int) -> None:
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLSubsetError(f"line {self.lines[i].number}: bad indentation")


def load(text: str) -> Any:
    """What ``yaml.safe_load(text)`` returns, for the subset."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if _empty(body):
            continue
        if body[0] == "\t":
            raise YAMLSubsetError(f"line {number}: a tab in the indentation")
        if raw.startswith(("---", "...")) and raw[3:4] in ("", " ", "\t"):
            raise YAMLSubsetError(f"line {number}: document markers are outside the subset")
        lines.append(_Line(number, len(raw) - len(body), body.rstrip(" \t")))
    if not lines:
        return None
    value, i = _Parser(lines).block(0, lines[0].indent)
    if i < len(lines):
        raise YAMLSubsetError(f"line {lines[i].number}: bad indentation")
    return value


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())
