"""Grammar/JSON-schema constrained decoding (compiler + runtime).

Counterpart of `defer_tpu/constrain/`. Host-side compile:
`compile_regex(pattern, vocab)` / `compile_json_schema(schema, vocab)`
lower a constraint spec into a dense token-level `TokenDFA` (dfa.py,
schema.py: numpy and the standard library). Device-side serve: pass the
compiled DFAs as `constraints={name: dfa}` to `DecodeServer` and select
per request with `SamplingParams(constraint=name)`; runtime.py holds the
stacked-table mask fold the ticks run on tensors.
"""

from defer_tpu_torch.constrain.dfa import (
    ConstraintError,
    TokenDFA,
    compile_regex,
    prune_dead_states,
)
from defer_tpu_torch.constrain.runtime import FREE_CID, stack_token_dfas
from defer_tpu_torch.constrain.schema import (
    compile_json_schema,
    schema_to_regex,
)

__all__ = [
    "ConstraintError",
    "TokenDFA",
    "compile_regex",
    "compile_json_schema",
    "schema_to_regex",
    "prune_dead_states",
    "stack_token_dfas",
    "FREE_CID",
]
