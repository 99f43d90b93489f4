"""JSON-schema subset -> regex lowering (compact canonical JSON).

The port's own copy of `defer_tpu/constrain/schema.py`.

`schema_to_regex` emits a pattern in the dialect dfa.py compiles —
and, by construction, a strict subset of Python `re` syntax, so a
test can check both `re.fullmatch(schema_to_regex(s), out)` and
`json.loads(out)` against the source schema.

Supported subset (production JSON-mode requests, not full
draft-2020): scalar types (`string`, `integer`, `number`,
`boolean`, `null`), `enum` of scalars, `array` with `items` /
`minItems` / `maxItems`, and `object` with `properties` — emitted
in declaration order with EVERY declared property present (the
canonical-form restriction that keeps the DFA linear in the schema;
`required` may name any subset and is implied). Whitespace is never
emitted: constrained decoding targets the compact form.
"""

from __future__ import annotations

import json

from defer_tpu_torch.constrain.dfa import ConstraintError, TokenDFA, compile_regex

_REGEX_SPECIAL = set("()[]{}|*+?.\\^$")

#: Compact-JSON string body: any char except quote/backslash, or a
#: backslash escape. Matches what json.dumps emits for sane text.
_STRING = r'"([^"\\]|\\.)*"'
_INTEGER = r"-?(0|[1-9][0-9]*)"
_NUMBER = _INTEGER + r"(\.[0-9]+)?([eE][+-]?[0-9]+)?"

#: Default bound for arrays with no maxItems: an unbounded array is
#: representable (the DFA loops), so None would be fine for the
#: compiler — but an explicit schema bound keeps generated outputs
#: finite under greedy decoding, so only `maxItems: null` opts out.
_UNBOUNDED = object()


def _literal(text: str) -> str:
    return "".join(
        "\\" + c if c in _REGEX_SPECIAL else c for c in text
    )


def _json_literal(value) -> str:
    return _literal(json.dumps(value, separators=(",", ":")))


def schema_to_regex(schema: dict) -> str:
    """Lower one schema node to a regex over its compact JSON form."""
    if not isinstance(schema, dict):
        raise ConstraintError(
            f"schema nodes must be dicts, got {type(schema).__name__}"
        )
    if "enum" in schema:
        opts = schema["enum"]
        if not opts:
            raise ConstraintError("enum must be non-empty")
        return "(" + "|".join(_json_literal(v) for v in opts) + ")"
    t = schema.get("type")
    if t == "string":
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "string"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems", _UNBOUNDED)
        if lo < 0 or (
            hi not in (None, _UNBOUNDED) and int(hi) < lo
        ):
            raise ConstraintError(
                f"array bounds minItems={lo} maxItems={hi} invalid"
            )
        if hi is _UNBOUNDED or hi is None:
            tail = f"({item})(,({item}))*"
            if lo > 1:
                tail = f"({item})(,({item})){{{lo - 1},}}"
            body = tail if lo >= 1 else f"({tail})?"
        else:
            hi = int(hi)
            if hi == 0:
                return r"\[\]"
            tail = f"({item})(,({item})){{{max(lo - 1, 0)},{hi - 1}}}"
            body = tail if lo >= 1 else f"({tail})?"
        return r"\[" + body + r"\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return r"\{\}"
        fields = ",".join(
            f'{_json_literal(k)}:({schema_to_regex(v)})'
            for k, v in props.items()
        )
        return r"\{" + fields + r"\}"
    raise ConstraintError(
        f"unsupported schema node {schema!r}: need enum or type in "
        "{string, integer, number, boolean, null, array, object}"
    )


def compile_json_schema(schema: dict, vocab: list[str]) -> TokenDFA:
    """schema -> regex -> TokenDFA against `vocab` (dfa.compile_regex
    semantics, including compile-time unsatisfiability errors)."""
    return compile_regex(schema_to_regex(schema), vocab)
