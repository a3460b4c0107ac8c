"""A reader of the YAML subset that OmegaConf and `yaml.safe_dump` write,
for the NeMo `model_config.yaml` of a `.nemo` and the repo's model
configs; the port reads them without PyYAML, which the machine with the
card lacks. `safe_load(text)` gives what `yaml.safe_load` gives on:

- block mappings and sequences (a sequence may sit at its key's indent, as
  safe_dump writes it; `- key: value` items are mappings);
- flow collections on one line, `[]`, `{}`, `[1, [2, 3]]`, `{a: 1}`;
- plain scalars resolved as PyYAML's safe resolver does: null (`null`,
  `Null`, `NULL`, `~`, nothing), booleans (true/false, yes/no, on/off in
  PyYAML's three casings), decimal ints, floats with a dot (`1.0e-06`,
  `.5`, `.inf`, `.nan`; `1e-5` stays a string, as in PyYAML) and strings
  (`???` among them), a plain scalar continued on more-indented lines;
- single-quoted strings (`''` is a quote) and double-quoted strings with
  backslash escapes (`\\uXXXX`, `\\n`, ...), either one folded over lines;
- comments.

Anything else raises ValueError rather than being guessed at: block
scalars (`|`, `>`), anchors, aliases, tags, directives, several documents,
octal, hex, base-60 numbers and timestamps.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_REFUSED = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def resolve(s: str) -> Any:
    """A plain scalar's value under PyYAML's safe resolver."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if _REFUSED.match(s):
        raise ValueError(f"YAML scalar {s!r}: octal, hex, base-60 and "
                         "timestamps are not read")
    if s[0] in "&*!%|>@`":
        raise ValueError(f"YAML {s!r}: anchors, aliases, tags, directives "
                         "and block scalars are not read")
    return s


def _strip_comment(line: str) -> str:
    """The line without its comment (a `#` at its start or after a space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at text[i] (its line breaks folded);
    returns (value, index after the closing quote)."""
    q, out, i = text[i], [], i + 1
    while True:
        if i >= len(text):
            raise ValueError("YAML: unterminated quoted string")
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return _fold("".join(out)), i + 1
        if c == "\\" and q == '"':
            e = text[i + 1]
            if e in _HEX:
                n = _HEX[e]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e == "\n":                   # escaped line break
                i += 2
                while i < len(text) and text[i] in " \t":
                    i += 1
                continue
            if e not in _ESCAPES:
                raise ValueError(f"YAML: unknown escape \\{e}")
            out.append("\x00\x01" + _ESCAPES[e] if e in " \t" else
                       _ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1


def _fold(s: str) -> str:
    """Flow folding of a quoted scalar over lines: a line break with its
    surrounding blanks becomes a space, each empty line a newline."""
    if "\n" not in s:
        return s.replace("\x00\x01", "")
    lines = s.split("\n")
    out = lines[0].rstrip(" \t")
    empties = 0
    for k, ln in enumerate(lines[1:], 1):
        ln = ln.lstrip(" \t")
        if k < len(lines) - 1:
            ln = ln.rstrip(" \t")
        if not ln and k < len(lines) - 1:
            empties += 1
            continue
        out += ("\n" * empties) if empties else " "
        empties = 0
        out += ln
    return out.replace("\x00\x01", "")


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """A flow node at text[i]: [...], {...}, a quoted or plain scalar."""
    while text[i] == " ":
        i += 1
    c = text[i]
    if c in "'\"":
        return _quoted(text, i)
    if c in "[{":
        close, items, i = "]" if c == "[" else "}", [], i + 1
        pairs = {}
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise ValueError("YAML: unclosed flow collection")
            if text[i] == close:
                return (items if close == "]" else pairs), i + 1
            key, i = _flow(text, i)
            while text[i] == " ":
                i += 1
            if close == "}":
                if text[i] != ":":
                    raise ValueError("YAML: flow mapping entry without ':'")
                pairs[key], i = _flow(text, i + 1)
            else:
                items.append(key)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"YAML: unexpected {text[i]!r} in a flow "
                                 "collection")
    j = i
    while j < len(text) and text[j] not in ",]}" and \
            not (text[j] == ":" and text[j + 1:j + 2] in (" ", ",", "]",
                                                         "}", "")):
        j += 1
    return resolve(text[i:j].strip()), j


def _scalar(text: str) -> Any:
    """The value text after `key:` or `- ` (one or more folded lines)."""
    text = text.strip()
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"YAML: trailing text after {text!r}")
        return value
    if "\n" in text:
        text = " ".join(ln.strip() for ln in text.split("\n"))
    return resolve(text)


def _key_split(content: str):
    """(key, rest) when `content` is a mapping entry, else None."""
    if content[0] in "'\"":
        key, i = _quoted(content, 0)
        rest = content[i:].lstrip(" ")
        return (key, rest[1:]) if rest.startswith(":") else None
    m = re.search(r":(?: |$)", content)
    if m is None or content[0] in "[{":
        return None
    return resolve(content[:m.start()].strip()), content[m.end():]


class _Lines:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.replace("\r\n", "\n").split("\n"):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("YAML: tab indentation")
            line = _strip_comment(raw)
            if not line.strip():
                self.lines.append((-1, ""))     # blank: kept for folding
                continue
            ind = len(line) - len(line.lstrip(" "))
            self.lines.append((ind, line[ind:]))

    def next(self, i: int) -> int:
        while i < len(self.lines) and self.lines[i][0] < 0:
            i += 1
        return i


def _continuation(lines: _Lines, i: int, ind: int, first: str):
    """`first` and the following lines indented past `ind` (a multi-line
    scalar), and the index after them."""
    parts, j = [first], i + 1
    while True:
        k = lines.next(j)
        if k >= len(lines.lines) or lines.lines[k][0] <= ind:
            return "\n".join(parts), k
        parts.extend([""] * (k - j))
        parts.append(lines.lines[k][1])
        j = k + 1


def _node(lines: _Lines, i: int, ind: int) -> Tuple[Any, int]:
    """The block node whose first line is lines[i], at indent `ind`."""
    content = lines.lines[i][1]
    if content == "-" or content.startswith("- "):
        return _seq(lines, i, ind)
    if _key_split(content) is not None:
        return _map(lines, i, ind)
    text, j = _continuation(lines, i, ind, content)
    return _scalar(text), j


def _value(lines: _Lines, i: int, ind: int, rest: str, seq_ok: bool):
    """The value after `key:` / `- ` at indent `ind` on line i."""
    if rest.strip():
        if rest.strip() in ("|", ">") or rest.strip()[0] in "|>":
            raise ValueError("YAML: block scalars are not read")
        text, j = _continuation(lines, i, ind, rest)
        return _scalar(text), j
    j = lines.next(i + 1)
    if j < len(lines.lines):
        n_ind, content = lines.lines[j]
        if n_ind > ind or (seq_ok and n_ind == ind and (
                content == "-" or content.startswith("- "))):
            return _node(lines, j, n_ind)
    return None, j


def _map(lines: _Lines, i: int, ind: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines.lines):
        n_ind, content = lines.lines[i]
        if n_ind != ind or content.startswith("- ") or content == "-":
            break
        split = _key_split(content)
        if split is None:
            raise ValueError(f"YAML: expected 'key:' at {content!r}")
        key, rest = split
        if key in out:
            raise ValueError(f"YAML: duplicate key {key!r}")
        out[key], i = _value(lines, i, ind, rest, True)
        i = lines.next(i)
    if i < len(lines.lines) and lines.lines[i][0] > ind:
        raise ValueError(f"YAML: bad indentation at {lines.lines[i][1]!r}")
    return out, i


def _seq(lines: _Lines, i: int, ind: int) -> Tuple[list, int]:
    out = []
    while i < len(lines.lines):
        n_ind, content = lines.lines[i]
        if n_ind != ind or not (content == "-" or content.startswith("- ")):
            break
        item = content[1:].lstrip(" ")
        col = ind + len(content) - len(item)
        if item and (item.startswith("- ") or item == "-"
                     or _key_split(item) is not None):
            lines.lines[i] = (col, item)         # the item's own block node
            value, i = _node(lines, i, col)
        else:
            value, i = _value(lines, i, ind, item, False)
        out.append(value)
        i = lines.next(i)
    return out, i


def safe_load(stream) -> Any:
    """`yaml.safe_load` on the subset above (a str, bytes or a text
    file)."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    lines = _Lines(text)
    i = lines.next(0)
    if i < len(lines.lines) and lines.lines[i][1].startswith("%"):
        raise ValueError("YAML: directives are not read")
    if i < len(lines.lines) and lines.lines[i][1] == "---":
        i = lines.next(i + 1)
    if i >= len(lines.lines):
        return None
    try:
        value, i = _node(lines, i, lines.lines[i][0])
    except IndexError:
        raise ValueError("YAML: unexpected end of a line or document") \
            from None
    i = lines.next(i)
    if i < len(lines.lines):
        raise ValueError(f"YAML: unexpected {lines.lines[i][1]!r} (several "
                         "documents or bad indentation)")
    return value
