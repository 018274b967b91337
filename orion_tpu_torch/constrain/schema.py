"""JSON-schema frontend: compile a (restricted) JSON schema to a regex
over the byte alphabet, which the regex frontend then turns into a DFA.

The translation is the outlines-style one (PAPERS.md 2307.09702): every
schema node becomes a regex fragment describing the exact byte sequence
of a conforming JSON value. Deliberate simplifications, documented in
README "Constrained decoding":

- Emitted JSON is COMPACT (no whitespace between tokens) — the grammar
  admits one canonical serialization, which keeps the DFA small and the
  forced-token runs long (punctuation like ``","`` and ``":"`` is a
  single legal continuation, i.e. a free draft).
- Object properties are emitted in declared order and all are required;
  ``required`` narrowing / optional-property combinatorics are out of
  scope for this pass.
- ``$ref``, ``allOf``, ``patternProperties`` and unconstrained
  ``additionalProperties`` objects are rejected with a typed error
  rather than silently accepted.
"""

from __future__ import annotations

import json
from typing import Optional

from orion_tpu_torch.constrain.regex import ConstraintError

__all__ = ["schema_to_regex", "STRING_INNER"]

# One JSON string character: anything but '"', '\' or a control byte,
# or a short escape, or a \uXXXX escape.
STRING_INNER = (
    r'([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
)
_STRING = f'"{STRING_INNER}*"'
_INTEGER = r"-?(0|[1-9][0-9]*)"
_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+\-]?[0-9]+)?"
_BOOLEAN = r"(true|false)"
_NULL = r"null"

_META = set("\\.[]{}()*+?|^$-")


def _quote(text: str) -> str:
    """Escape a literal string for the regex frontend."""
    out = []
    for ch in text:
        if ch in _META:
            out.append("\\" + ch)
        elif ch == "\n":
            out.append(r"\n")
        elif ch == "\t":
            out.append(r"\t")
        elif ch == "\r":
            out.append(r"\r")
        else:
            out.append(ch)
    return "".join(out)


def _const(value) -> str:
    return _quote(json.dumps(value, separators=(",", ":"),
                             ensure_ascii=True))


def _string_fragment(node: dict) -> str:
    lo = node.get("minLength")
    hi = node.get("maxLength")
    if lo is None and hi is None:
        return _STRING
    lo = 0 if lo is None else int(lo)
    rep = f"{{{lo},{int(hi)}}}" if hi is not None else f"{{{lo},}}"
    return f'"{STRING_INNER}{rep}"'


def _array_fragment(node: dict, depth: int) -> str:
    item = _fragment(node.get("items", {}), depth + 1) \
        if "items" in node else f"({_NUMBER}|{_STRING}|{_BOOLEAN}|{_NULL})"
    lo = int(node.get("minItems", 0))
    hi = node.get("maxItems")
    if hi is not None:
        hi = int(hi)
        if hi < lo:
            raise ConstraintError(
                f"array maxItems={hi} < minItems={lo}"
            )
        if hi == 0:
            return r"\[\]"
    if lo == 0:
        tail = f"({item}(,{item})*)?" if hi is None else (
            f"({item}(,{item}){{0,{hi - 1}}})?"
        )
    else:
        tail = f"{item}(,{item}){{{lo - 1},}}" if hi is None else (
            f"{item}(,{item}){{{lo - 1},{hi - 1}}}"
        )
    return r"\[" + tail + r"\]"


def _object_fragment(node: dict, depth: int) -> str:
    props = node.get("properties")
    if not props:
        if node.get("additionalProperties") is False or props == {}:
            return r"\{\}"
        raise ConstraintError(
            "object schema without 'properties' is unbounded; declare "
            "the properties (or additionalProperties: false for {})"
        )
    parts = []
    for key, sub in props.items():
        parts.append(f'"{_quote(key)}":{_fragment(sub, depth + 1)}')
    return r"\{" + ",".join(parts) + r"\}"


def _fragment(node, depth: int = 0) -> str:
    if depth > 32:
        raise ConstraintError("schema nesting exceeds depth cap 32")
    if node is True or node == {}:
        # Permissive node: any scalar JSON value (containers need an
        # explicit schema to stay bounded).
        return f"({_NUMBER}|{_STRING}|{_BOOLEAN}|{_NULL})"
    if not isinstance(node, dict):
        raise ConstraintError(f"schema node must be an object: {node!r}")
    for bad in ("$ref", "allOf", "patternProperties"):
        if bad in node:
            raise ConstraintError(f"unsupported schema keyword {bad!r}")
    if "const" in node:
        return _const(node["const"])
    if "enum" in node:
        opts = node["enum"]
        if not opts:
            raise ConstraintError("empty enum matches nothing")
        return "(" + "|".join(_const(v) for v in opts) + ")"
    for key in ("anyOf", "oneOf"):
        if key in node:
            opts = node[key]
            if not opts:
                raise ConstraintError(f"empty {key} matches nothing")
            return "(" + "|".join(
                _fragment(o, depth + 1) for o in opts
            ) + ")"
    ty = node.get("type")
    if isinstance(ty, list):
        return "(" + "|".join(
            _fragment({**node, "type": t}, depth + 1) for t in ty
        ) + ")"
    if ty == "string":
        if "pattern" in node:
            # The schema's own regex, anchored by our full-match
            # semantics, quoted inside JSON string delimiters.
            return f'"{node["pattern"]}"'
        return _string_fragment(node)
    if ty == "integer":
        return _INTEGER
    if ty == "number":
        return _NUMBER
    if ty == "boolean":
        return _BOOLEAN
    if ty == "null":
        return _NULL
    if ty == "array":
        return _array_fragment(node, depth)
    if ty == "object":
        return _object_fragment(node, depth)
    raise ConstraintError(f"unsupported schema type {ty!r}")


def schema_to_regex(schema) -> str:
    """Compile a JSON schema (dict, or JSON text) to an anchored regex
    accepting exactly the compact serializations of conforming values."""
    if isinstance(schema, (str, bytes)):
        try:
            schema = json.loads(schema)
        except ValueError as e:
            raise ConstraintError(f"json_schema is not valid JSON: {e}")
    return _fragment(schema)
