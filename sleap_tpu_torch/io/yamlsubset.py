"""A reader and a writer of the YAML that ImgStore metadata and DeepLabCut
project configs hold, without PyYAML (the card's Python has none).

:func:`yaml_load` reads as PyYAML's ``safe_load`` reads: block mappings
(keys may be quoted, or plain Windows paths such as ``C:\\data\\a.avi:``),
block sequences (at their key's indentation too, and nested in the compact
``- - a`` form), flow sequences and mappings (across lines too), plain,
single- and double-quoted scalars, comments, and plain scalars resolved by
PyYAML's YAML 1.1 rules: nulls (``~``, ``null``, empty), booleans
(``true``/``yes``/``on`` and their negatives, in three casings), integers
(decimal, ``0b``, ``0x``, leading-zero octal, sexagesimal) and floats
(a dot required, a signed exponent, ``.inf``, ``.nan``); anything else,
such as ``0, 832, 0, 480``, stays a string. Timestamps stay strings (PyYAML
makes them ``datetime``). Mappings inside block sequences, anchors, tags and
block scalars raise ``ValueError`` naming the line.

:func:`yaml_dump` writes as ``yaml.safe_dump`` writes nested dicts, lists
(of scalars, or of lists of scalars) and scalars: block style, keys sorted,
sequence items at their key's indentation, and strings quoted where they
would not read back as themselves.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = {v: v.lower() in ("yes", "true", "on") for base in ("yes", "no", "true", "false", "on", "off")
         for v in (base, base.capitalize(), base.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
                      |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN)""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def _sexagesimal(text: str, cast) -> Any:
    value = 0
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


def _double_quoted(body: str, where: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1:i + 2]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"{where}: unknown escape '\\{code}' in a double-quoted scalar.")
    return "".join(out)


def _scalar(text: str, where: str) -> Any:
    """A plain or quoted scalar, resolved as PyYAML resolves it."""
    text = text.strip()
    if text[:1] == '"':
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"{where}: unterminated double-quoted scalar.")
        return _double_quoted(text[1:-1], where)
    if text[:1] == "'":
        if not text.endswith("'") or len(text) < 2:
            raise ValueError(f"{where}: unterminated single-quoted scalar.")
        return text[1:-1].replace("''", "'")
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"{where}: YAML {text[:1]!r} (anchors, tags, block scalars) is not supported.")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return _int(text)
    if _FLOAT.fullmatch(text):
        return _float(text)
    return text


def _split_flow(body: str, where: str) -> List[str]:
    """The comma-separated items of a flow collection's body, nested
    brackets and quotes kept whole."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    if quote or depth:
        raise ValueError(f"{where}: unbalanced flow collection.")
    items.append(body[start:])
    return [item for item in items if item.strip()]


def _value(text: str, where: str) -> Any:
    """A scalar, or a flow sequence or mapping, on one line."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: flow sequences must close on their line.")
        return [_value(item, where) for item in _split_flow(text[1:-1], where)]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise ValueError(f"{where}: flow mappings must close on their line.")
        out = {}
        for item in _split_flow(text[1:-1], where):
            key, sep, rest = _key_split(item)
            if not sep:
                raise ValueError(f"{where}: flow mapping item {item.strip()!r} has no key.")
            out[_scalar(key, where)] = _value(rest, where)
        return out
    return _scalar(text, where)


def _key_split(text: str) -> Tuple[str, str, str]:
    """``key: rest`` at the first ": " (or a trailing ":") outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i], ":", text[i + 1:]
        elif ch in "[{" and i == 0:
            break
    return text, "", ""


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " \t-:[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _open_brackets(text: str) -> int:
    """How many flow brackets ``text`` leaves open, outside quotes."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def yaml_load(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("---", "..."):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tabs in indentation are not YAML.")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if lines and _open_brackets(lines[-1][1]) > 0:  # a flow collection goes on
            indent, head, where = lines[-1]
            lines[-1] = (indent, head + " " + line.strip(), where)
        else:
            lines.append((len(line) - len(line.lstrip(" ")), line.strip(), f"line {n}"))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"{lines[end][2]}: unexpected indentation.")
    return value


def _block(lines: list, i: int, indent: int) -> Tuple[Any, int]:
    """The block collection (or lone scalar) whose lines start at ``i`` with
    ``indent``; returns it and the index past it."""
    _, text, where = lines[i]
    if _is_item(text):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest, where = lines[i][1][1:].strip(), lines[i][2]
            if _is_item(rest):  # "- - a": a sequence nested in the compact form
                inner = indent + len(lines[i][1]) - len(rest)
                lines[i] = (inner, rest, where)
                item, i = _block(lines, i, inner)
                out.append(item)
                continue
            i += 1
            if rest:
                _, sep, _ = _key_split(rest)
                if sep and not rest.startswith(("[", "{")):
                    raise ValueError(f"{where}: mappings inside block sequences are not supported.")
                out.append(_value(rest, where))
            elif i < len(lines) and lines[i][0] > indent:
                item, i = _block(lines, i, lines[i][0])
                out.append(item)
            else:
                out.append(None)
        return out, i
    _, sep, _ = _key_split(text)
    if not sep:
        return _value(text, where), i + 1
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        _, text, where = lines[i]
        key, sep, rest = _key_split(text)
        if not sep:
            raise ValueError(f"{where}: expected 'key: value', found {text!r}.")
        i += 1
        if rest.strip():
            out[_scalar(key, where)] = _value(rest, where)
        elif i < len(lines) and (lines[i][0] > indent or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[_scalar(key, where)], i = _block(lines, i, lines[i][0])
        else:
            out[_scalar(key, where)] = None
    return out, i


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    text = str(value)
    try:
        plain = bool(text) and _scalar(text, "") == text
    except ValueError:
        plain = False
    if plain and not re.search(r"[:#,\[\]{}]|^[-?\s'\"&*!|>%@`]|\s$", text):
        return text
    return "'" + text.replace("'", "''") + "'"


def _dump_sequence(items: list, pad: str) -> str:
    out = ""
    for item in items:
        if isinstance(item, dict) and item:
            raise ValueError("yaml_dump writes no mappings inside sequences.")
        if isinstance(item, (list, tuple)) and item:
            inner = _dump_sequence(list(item), pad + "  ")
            out += f"{pad}- " + inner[len(pad) + 2:]
        elif isinstance(item, (list, tuple)):
            out += f"{pad}- []\n"
        elif isinstance(item, dict):
            out += f"{pad}- {{}}\n"
        else:
            out += f"{pad}- {_dump_scalar(item)}\n"
    return out


def yaml_dump(value: Any, indent: int = 0) -> str:
    """``yaml.safe_dump`` of nested dicts, lists and scalars: block style,
    keys sorted, sequence items at their key's indentation."""
    pad = " " * indent
    if isinstance(value, dict):
        out = ""
        for key in sorted(value):
            item = value[key]
            if isinstance(item, dict) and item:
                out += f"{pad}{_dump_scalar(key)}:\n" + yaml_dump(item, indent + 2)
            elif isinstance(item, (list, tuple)) and item:
                out += f"{pad}{_dump_scalar(key)}:\n" + _dump_sequence(list(item), pad)
            else:
                text = ("{}" if isinstance(item, dict) else "[]" if isinstance(item, (list, tuple))
                        else _dump_scalar(item))
                out += f"{pad}{_dump_scalar(key)}: {text}\n"
        return out
    if isinstance(value, (list, tuple)):
        return _dump_sequence(list(value), pad)
    return f"{pad}{_dump_scalar(value)}\n"
