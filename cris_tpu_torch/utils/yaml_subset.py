"""A reader of the YAML that the repository's config files use, in the
standard library alone, so that a config reads the same on every machine
(the card's may lack PyYAML).

``load(text)`` gives what ``yaml.safe_load`` gives for the subset:

- block mappings two levels deep (``SECTION:`` at column 0, its keys
  indented alike), a top-level key with a scalar value, an empty value as
  None, a repeated key keeping its last value;
- full-line and trailing comments (``#`` at the start of a line or after
  whitespace, never inside quotes);
- plain scalars typed by PyYAML's YAML 1.1 implicit resolver (``bool``,
  ``float``, ``int``, ``null``, else ``str``; ``1e-4`` is a string, ``010``
  is 8, ``1:20`` is 80, ``yes`` / ``off`` are bools, ``~`` is None);
- single-quoted (``''`` is a quote) and double-quoted (PyYAML's escapes)
  strings on one line;
- flow lists of scalars on one line (``[512, 1024, 1024]``).

Anything else (anchors, aliases, tags, block scalars, documents, flow
mappings, nested flow lists, block sequences, tabs, a third level of
nesting, multi-line scalars, a timestamp) raises ``ValueError`` naming the
file, the line and the construct.
"""

from __future__ import annotations

import re

__all__ = ["load", "load_file"]

# PyYAML's implicit resolver (yaml/resolver.py), tried in this order
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
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
# yaml/scanner.py's escapes in a double-quoted scalar
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# what a plain scalar may not start with, by the construct it would begin
_STARTS = {"&": "an anchor", "*": "an alias", "!": "a tag",
           "|": "a block scalar", ">": "a block scalar",
           "{": "a flow mapping", "%": "a directive", "@": "a reserved '@'",
           "`": "a reserved '`'", "]": "a stray ']'", "}": "a stray '}'",
           ",": "a stray ','"}


class _Refused(Exception):
    """A construct outside the subset, named."""


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _int(value: str) -> int:
    """yaml/constructor.py construct_yaml_int."""
    value = value.replace("_", "")
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


def _float(value: str) -> float:
    """yaml/constructor.py construct_yaml_float."""
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _resolve(plain: str):
    """A plain scalar's value, as PyYAML's resolver and SafeConstructor
    give it."""
    first = plain[:1]
    if first and first in "yYnNtTfFoO" and _BOOL.match(plain):
        return _BOOLS[plain.lower()]
    if first and first in "-+0123456789." and _FLOAT.match(plain):
        return _float(plain)
    if first and first in "-+0123456789" and _INT.match(plain):
        try:
            return _int(plain)
        except ValueError:
            raise _Refused(f"the integer {plain!r}, which PyYAML cannot read")
    if first == "<" and plain == "<<":
        raise _Refused("a merge key '<<'")
    if (not first or first in "~nN") and _NULL.match(plain):
        return None
    if first and first in "0123456789" and _TIMESTAMP.match(plain):
        raise _Refused(f"the timestamp {plain!r}")
    if plain == "=":
        raise _Refused("a value key '='")
    return plain


def _quoted(text: str, i: int):
    """(the string of the quoted scalar at text[i], the index after it)."""
    quote = text[i]
    out, j = [], i + 1
    while j < len(text):
        c = text[j]
        if quote == "'":
            if c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(c)
            j += 1
            continue
        if c == '"':
            return "".join(out), j + 1
        if c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _ESCAPE_CODES:
                n = _ESCAPE_CODES[e]
                code = text[j + 2:j + 2 + n]
                if len(code) != n or any(d not in "0123456789abcdefABCDEF"
                                         for d in code):
                    raise _Refused(f"a bad escape '\\{e}{code}'")
                out.append(chr(int(code, 16)))
                j += 2 + n
            else:
                raise _Refused(f"the escape '\\{e}'" if e else
                               "a double-quoted scalar over several lines")
            continue
        out.append(c)
        j += 1
    raise _Refused("a quoted scalar over several lines")


def _check_plain_start(text: str, flow: bool):
    c, nxt = text[0], text[1:2]
    if c == "\t":
        raise _Refused("a tab")
    if c in _STARTS:
        raise _Refused(_STARTS[c])
    if c == "[":
        raise _Refused("a nested flow list" if flow else
                       "a flow list over several lines")
    if c in "-?:" and nxt in ("", " "):
        raise _Refused({"-": "a block sequence", "?": "a complex key",
                        ":": "an empty key"}[c])


def _value(text: str):
    """A value's text (after 'key:' and its spaces) -> its value; the rest
    of the line may only be a comment."""
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"":
        value, j = _quoted(text, 0)
        rest = text[j:].lstrip(" ")
        if rest and not rest.startswith("#"):
            raise _Refused("text after a quoted scalar")
        return value
    if text[0] == "[":
        return _flow_list(text)
    _check_plain_start(text, flow=False)
    plain = re.split(r" #", text, maxsplit=1)[0].rstrip(" ")
    if "\t" in plain:
        raise _Refused("a tab")
    if re.search(r":( |$)", plain):
        raise _Refused("a mapping inside a value")
    return _resolve(plain)


def _flow_list(text: str) -> list:
    items, i = [], 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text) or text[i] == "#":
            raise _Refused("a flow list over several lines")
        c = text[i]
        if c == "]":
            i += 1
            break
        if c == ",":
            if expect_item:
                raise _Refused("an empty entry in a flow list")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise _Refused("a flow list entry without a ','")
        if c in "'\"":
            value, i = _quoted(text, i)
        else:
            _check_plain_start(text[i:], flow=True)
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                if text[j] == "#" and text[j - 1] == " ":
                    break
                if text[j] == ":" and text[j + 1:j + 2] in ("", " ", ",", "[",
                                                          "]", "{", "}"):
                    raise _Refused("a flow mapping in a flow list")
                j += 1
            plain = text[i:j].rstrip(" ")
            if "\t" in plain:
                raise _Refused("a tab")
            if j < len(text) and text[j] in "[{":
                raise _Refused("a nested flow list" if text[j] == "[" else
                               "a flow mapping")
            value = _resolve(plain)
            i = j
        items.append(value)
        expect_item = False
    rest = text[i:].lstrip(" ")
    if rest and not rest.startswith("#"):
        raise _Refused("text after a flow list")
    return items


def _key(text: str):
    """(the key, the text after its ':') of 'key: value' or 'key:'."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        rest = text[j:].lstrip(" ")
        if not rest.startswith(":"):
            raise _Refused("a quoted scalar where a key was expected")
        return key, rest[1:]
    if text[0] in "[{":
        raise _Refused("a flow collection as a key")
    _check_plain_start(text, flow=False)
    if re.search(r":\t", text.split(" #")[0]):
        raise _Refused("a tab")
    m = re.search(r":( |$)", text)
    if not m or " #" in text[:m.start()]:
        raise _Refused("a line that is not 'key: value'")
    key = text[:m.start()].rstrip(" ")
    if "\t" in key:
        raise _Refused("a tab")
    return _resolve(key), text[m.end():]


def load(text: str, name: str = "<string>"):
    """``yaml.safe_load(text)`` for the subset; ``name`` is the file named
    in a refusal."""
    root: dict = {}
    section = None        # the open top-level key whose value is a mapping
    indent = None         # its keys' column
    last_scalar = False   # the previous entry had a value on its line
    seen = False
    for number, raw in enumerate(text.lstrip("\ufeff").split("\n"), 1):
        line = raw.rstrip("\r")
        try:
            stripped = line.lstrip(" ")
            if stripped.startswith("\t"):
                raise _Refused("a tab in the indentation")
            if not stripped or stripped.startswith("#"):
                continue
            col = len(line) - len(stripped)
            if col == 0 and (stripped.startswith("---") or
                             stripped.startswith("...")) and \
                    stripped[3:4] in ("", " "):
                raise _Refused("a document marker '---' or '...'")
            seen = True
            if col == 0:
                key, rest = _key(stripped)
                rest = rest.lstrip(" ")
                if rest and not rest.startswith("#"):
                    root[key] = _value(rest)
                    section, indent, last_scalar = None, None, True
                else:
                    root[key] = None
                    section, indent, last_scalar = key, None, False
                continue
            if section is None:
                raise _Refused("a multi-line scalar" if last_scalar else
                               "an indented top-level key")
            if indent is None:
                indent = col
                root[section] = {}
            elif col > indent:
                raise _Refused("a multi-line scalar" if last_scalar else
                               "a third level of nesting")
            elif col < indent:
                raise _Refused("a key indented unlike its section's")
            key, rest = _key(stripped)
            rest = rest.lstrip(" ")
            # an empty value is None, unless deeper lines follow (refused
            # above when they come)
            last_scalar = bool(rest) and not rest.startswith("#")
            root[section][key] = _value(rest) if last_scalar else None
        except _Refused as e:
            raise ValueError(f"{name}:{number}: {e} is not supported by the "
                             "config reader (the subset of YAML that the "
                             "config files use)") from None
    return root if seen else None


def load_file(path: str):
    """``load`` of a file's text."""
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read(), path)
