"""The subset of OpenCV's YAML persistence (``cv::FileStorage``) that the
template database uses, in plain Python.

Read: block mappings and sequences by indentation, flow sequences
``[ a, b, ... ]`` (nested, and continued over several lines), ints,
floats (``10.``, ``1e-05``, ``.Inf``, ``.NaN``) and plain or quoted
strings; ``%YAML`` directives, ``---`` and ``#`` comments are skipped.
Write: dicts as block mappings, lists of scalars as flow sequences and any
other list as a block sequence — the layout ``cv::FileStorage`` itself
writes for this schema, so OpenCV reads the output unchanged.  A ``.gz``
path is gzip-compressed, as OpenCV does.
"""

from __future__ import annotations

import gzip
import math
import re
from typing import Any, List, Tuple

_INT = re.compile(r"[-+]?\d+$")
_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")
_SPECIAL = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
            ".nan": math.nan}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t", encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return _SPECIAL.get(tok.lower(), tok)


def _flow(text: str):
    """Parse one complete flow sequence ``[ ... ]`` (may nest)."""
    stack: List[list] = []
    tok = ""
    out = None
    for ch in text:
        if ch == "[":
            stack.append([])
        elif ch in ",]":
            if tok.strip():
                stack[-1].append(_scalar(tok))
            tok = ""
            if ch == "]":
                done = stack.pop()
                if stack:
                    stack[-1].append(done)
                else:
                    out = done
        else:
            tok += ch
    return out


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        body = raw.strip()
        if not body or body[0] in "%#" or body == "---" or body == "...":
            continue
        out.append((len(raw) - len(raw.lstrip(" ")), body))
    return out


class _Parser:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.i = 0

    def _flow_value(self, first: str):
        """A flow sequence starting at ``first``, joined with as many
        following lines as its brackets need."""
        text = first
        while text.count("[") > text.count("]"):
            text += " " + self.lines[self.i][1]
            self.i += 1
        return _flow(text)

    def _inline(self, rest: str, indent: int):
        if rest.startswith("["):
            return self._flow_value(rest)
        if rest:
            return _scalar(rest)
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            return self.block(self.lines[self.i][0])
        if (self.i < len(self.lines) and self.lines[self.i][0] == indent
                and self.lines[self.i][1].startswith("-")):
            return self.block(indent)         # "key:" then "- item" lines
        return None

    def block(self, indent: int):
        body = self.lines[self.i][1]
        if body.startswith("["):          # flow value on its own line
            self.i += 1
            return self._flow_value(body)
        if body == "-" or body.startswith("- "):
            seq = []
            while (self.i < len(self.lines) and self.lines[self.i][0] == indent
                   and (self.lines[self.i][1] == "-"
                        or self.lines[self.i][1].startswith("- "))):
                rest = self.lines[self.i][1][1:].strip()
                self.i += 1
                seq.append(self._inline(rest, indent))
            return seq
        node = {}
        while self.i < len(self.lines) and self.lines[self.i][0] == indent:
            body = self.lines[self.i][1]
            if body.startswith("-"):
                break
            key, _, rest = body.partition(":")
            self.i += 1
            node[_scalar(key)] = self._inline(rest.strip(), indent)
        return node


def load(path: str) -> Any:
    """Read an OpenCV YAML file -> nested dicts, lists and scalars."""
    with _open(path, "r") as f:
        parser = _Parser(f.read())
    if not parser.lines:
        return {}
    return parser.block(parser.lines[0][0])


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".Nan"
        if math.isinf(v):
            return ".Inf" if v > 0 else "-.Inf"
        text = repr(v)
        return text if ("." in text or "e" in text) else text + "."
    text = str(v)
    if (not text or _INT.match(text) or _FLOAT.match(text)
            or any(c in text for c in ":#[]{},\"'") or text != text.strip()):
        return '"' + text.replace('"', '\\"') + '"'
    return text


def _is_scalar(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(out: List[str], node, indent: int) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, val in node.items():
            if _is_scalar(val):
                out.append(f"{pad}{key}: {_fmt(val)}")
            elif isinstance(val, (list, tuple)) and all(map(_is_scalar, val)):
                out.append(f"{pad}{key}: [ " + ", ".join(map(_fmt, val))
                           + " ]" if val else f"{pad}{key}: []")
            else:
                out.append(f"{pad}{key}:")
                _emit(out, val, indent + 3)
        return
    for item in node:
        if _is_scalar(item):
            out.append(f"{pad}- {_fmt(item)}")
        elif isinstance(item, (list, tuple)) and all(map(_is_scalar, item)):
            out.append(f"{pad}- [ " + ", ".join(map(_fmt, item)) + " ]")
        else:
            out.append(f"{pad}-")
            _emit(out, item, indent + 3)


def dump(path: str, root: dict) -> None:
    """Write ``root`` (a dict) as an OpenCV YAML file."""
    out = ["%YAML:1.0", "---"]
    _emit(out, root, 0)
    with _open(path, "w") as f:
        f.write("\n".join(out) + "\n")
