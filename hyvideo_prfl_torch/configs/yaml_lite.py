"""A reader for the YAML that the repository's configs use, without pyyaml.

The machine with the card has no pyyaml, so the port reads its configs
itself. ``loads`` takes the subset that ``configs/*.yaml`` is written in
and returns the tree ``yaml.safe_load`` returns for it, types included:

- block mappings, and block sequences of scalars and flow lists
  (``- item``, indented under their key or level with it);
- flow lists, nested or not (``[1, 2, 2]``, ``[]``, ``["q", "k"]``);
- plain, single-quoted and double-quoted scalars on one line;
- full-line and trailing ``#`` comments.

Plain scalars are typed by pyyaml's YAML 1.1 rules (its implicit
resolvers, in its order): null (``~``, ``null``, empty), bool (``true``,
``yes``, ``on`` and their opposites, in three cases), int (decimal, ``0b``,
``0x``, a leading 0 for octal, ``_`` separators, ``1:30`` base 60) and float
(a dot is required: ``1e-5`` stays a string, ``1.0e+5`` is a float, ``0.``
is 0.0), everything else a string. Anything outside the subset raises
``YamlError`` with its line: anchors and aliases, tags, ``|`` and ``>``
blocks, flow mappings, a mapping inside a sequence, multi-line scalars,
documents markers and directives, timestamps, merge keys, and tabs.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# characters a plain scalar may not start with (YAML's indicators), beyond
# the quotes and '[' that start the other scalar forms
_NO_PLAIN_START = set("&*!|>{}%@`,]")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


class YamlError(ValueError):
    """The text lies outside the subset the reader takes."""


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
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
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _plain(text: str, where: str) -> Any:
    """A plain scalar, typed as pyyaml's implicit resolvers type it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if text == "<<" or text == "=":
        raise YamlError(f"{where}: {text!r} (a merge key or a value tag) is not supported")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YamlError(f"{where}: the timestamp {text!r} is not supported")
    return text


def _quoted(text: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] and the index after it."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
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
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX:
                digits = text[i + 2:i + 2 + _HEX[esc]]
                if len(digits) != _HEX[esc] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YamlError(f"{where}: a bad \\{esc} escape")
                out.append(chr(int(digits, 16)))
                i += 2 + _HEX[esc]
            else:
                raise YamlError(f"{where}: the escape \\{esc} is not supported")
            continue
        out.append(ch)
        i += 1
    raise YamlError(f"{where}: a quoted scalar must end on its line")


def _strip_comment(line: str, where: str) -> str:
    """The line without its comment and trailing spaces (a '#' starts a
    comment at the line's start or after a space, outside quotes)."""
    i = 0
    while i < len(line):
        ch = line[i]
        if ch in "'\"" and (i == 0 or line[i - 1] in " [,:-"):
            _, i = _quoted(line, i, where)
            continue
        if ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip(" ")
        i += 1
    return line.rstrip(" ")


def _flow_list(text: str, i: int, where: str) -> Tuple[List[Any], int]:
    """The flow list starting at text[i] == '[' and the index after it."""
    items: List[Any] = []
    i += 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YamlError(f"{where}: a flow list must end on its line")
        ch = text[i]
        if ch == "]":  # also after a trailing comma, as pyyaml reads it
            return items, i + 1
        if not expect_item or ch == ",":
            raise YamlError(f"{where}: expected an item, then ',' or ']', in a flow list")
        if ch == "[":
            item, i = _flow_list(text, i, where)
        elif ch in "'\"":
            item, i = _quoted(text, i, where)
        elif ch == "{":
            raise YamlError(f"{where}: flow mappings are not supported")
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                if text[j] == ":" and text[j + 1:j + 2] in (" ", ",", "]", ""):
                    raise YamlError(f"{where}: a mapping inside a flow list is not supported")
                j += 1
            word = text[i:j].rstrip(" ")
            if word[0] in _NO_PLAIN_START or word in "-?:" or word[:2] in ("- ", "? "):
                raise YamlError(f"{where}: {word!r} is not a scalar the reader takes")
            item, i = _plain(word, where), j
        items.append(item)
        expect_item = False
        while i < len(text) and text[i] == " ":
            i += 1
        if i < len(text) and text[i] == ",":
            expect_item = True
            i += 1


def _value(text: str, where: str) -> Any:
    """A scalar or a flow list that fills the rest of a line."""
    if text[0] == "[":
        value, end = _flow_list(text, 0, where)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0, where)
    else:
        if (text[0] in _NO_PLAIN_START or text[0] in "-?:" and text[1:2] in (" ", "")
                or ": " in text or text.endswith(":")):
            raise YamlError(f"{where}: {text!r} is not a scalar the reader takes "
                            "(anchors, aliases, tags, | and > blocks, flow mappings and "
                            "nested mappings on one line are not supported)")
        return _plain(text, where)
    if text[end:].strip(" "):
        raise YamlError(f"{where}: unexpected {text[end:]!r} after a value")
    return value


def _split_key(text: str, where: str):
    """(key, rest) of a mapping entry 'key: rest' / 'key:', else None."""
    if text[0] in "'\"":
        key, i = _quoted(text, 0, where)
        if text[i:i + 1] != ":" or text[i + 1:i + 2] not in (" ", ""):
            return None
        return key, text[i + 1:].strip(" ")
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    word = text[:m.start()].rstrip(" ")
    if not word or word[0] in _NO_PLAIN_START or word[0] in "[-?":
        raise YamlError(f"{where}: {word!r} is not a key the reader takes")
    return _plain(word, where), text[m.end():].strip(" ")


class _Lines:
    def __init__(self, text: str, name: str):
        self.rows = []  # (indent, content, where)
        for n, raw in enumerate(text.splitlines(), 1):
            where = f"{name}:{n}"
            if "\t" in raw:
                raise YamlError(f"{where}: tabs are not supported")
            line = _strip_comment(raw, where)
            if not line.strip(" "):
                continue
            content = line.lstrip(" ")
            if content in ("---", "...") or content.startswith(("--- ", "... ", "%")):
                raise YamlError(f"{where}: document markers and directives are not supported")
            self.rows.append((len(line) - len(content), content, where))


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, i: int, indent: int):
    if _is_item(lines.rows[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines: _Lines, i: int, indent: int):
    out = []
    while i < len(lines.rows):
        ind, content, where = lines.rows[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"{where}: unexpected indentation")
        if not _is_item(content):
            break
        item = content[1:].strip(" ")
        if not item or _is_item(item) or _split_key(item, where) is not None:
            raise YamlError(f"{where}: a sequence item must be a scalar or a flow list")
        out.append(_value(item, where))
        i += 1
    return out, i


def _mapping(lines: _Lines, i: int, indent: int):
    out = {}
    while i < len(lines.rows):
        ind, content, where = lines.rows[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"{where}: unexpected indentation (a multi-line scalar?)")
        if _is_item(content):
            raise YamlError(f"{where}: a sequence item where a mapping entry was expected")
        entry = _split_key(content, where)
        if entry is None:
            raise YamlError(f"{where}: expected 'key: value'")
        key, rest = entry
        i += 1
        if rest:
            out[key] = _value(rest, where)
            continue
        nxt = lines.rows[i] if i < len(lines.rows) else None
        if nxt is not None and (nxt[0] > indent or (nxt[0] == indent and _is_item(nxt[1]))):
            out[key], i = _block(lines, i, nxt[0])
        else:
            out[key] = None
    return out, i


def loads(text: str, name: str = "<yaml>") -> Any:
    """The tree of one YAML document in the configs' subset (None when it
    is empty), as ``yaml.safe_load`` gives it."""
    lines = _Lines(text, name)
    if not lines.rows:
        return None
    first_indent, first, where = lines.rows[0]
    if not _is_item(first) and _split_key(first, where) is None:
        if len(lines.rows) > 1:
            raise YamlError(f"{lines.rows[1][2]}: a document holds one scalar or one block")
        return _value(first, where)
    tree, i = _block(lines, 0, first_indent)
    if i < len(lines.rows):
        raise YamlError(f"{lines.rows[i][2]}: unexpected indentation")
    return tree


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read(), path)
