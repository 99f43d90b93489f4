"""The port's constrained decoding (defer_tpu_torch/constrain/ and
DecodeServer(constraints=)) against the JAX package's.

The compiler is the port's own copy, so its tables must equal the JAX
package's element for element. Served through the flat DecodeServer on
the same weights (carried over with `params_from_jax`), constrained
greedy output must be token-identical to the JAX package's at
decode_window 1 and 4, free riders in the same batch included, and a
hand-built DFA that dead-ends must surface as a per-request error, as
the JAX package reports it. Float32 throughout.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu import constrain as jcon
from defer_tpu.constrain import runtime as jcrt
from defer_tpu.models.gpt import SamplingParams as JaxSamplingParams
from defer_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from defer_tpu.runtime.decode_server import DecodeServer as JaxDecodeServer
from defer_tpu_torch import constrain as con
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.constrain import runtime as crt
from defer_tpu_torch.models.gpt import SamplingParams, tiny_gpt
from defer_tpu_torch.runtime.decode_server import DecodeServer

CPU = torch.device("cpu")
# The JAX package's test vocabulary (tests/test_constrain.py): id 0 is
# the empty string and doubles as eos, then single chars, a few
# multi-char tokens, then filler.
_CHARS = list("0123456789abcdefghijklmnopqrstuvwxyz{}[]\",:.- eE+")
VOCAB = [""] + _CHARS + ["ab", "12", '":', "},"]
VOCAB += [f"<u{i}>" for i in range(128 - len(VOCAB))]
DIGITS = "[0-9]+"
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
EOS = 0
PATTERNS = [DIGITS, "(ab|a)c*", "12+", "[^0-9]{2,3}x?", r"\d\w\s?"]
SCHEMAS = [
    SCHEMA,
    {"type": "array", "items": {"type": "integer"}, "maxItems": 3},
    {"enum": ["a", 1, None]},
    {"type": "object", "properties": {"n": {"type": "number"},
                                      "s": {"type": "string"}}},
]


def detok(ids):
    return "".join(VOCAB[int(t)] for t in np.asarray(ids).ravel())


@pytest.fixture(scope="module")
def model():
    jdec = jax_tiny_gpt(64)
    jparams = jdec.init(jax.random.key(0))
    return (tiny_gpt(64, device=CPU), params_from_jax(jparams, CPU), jdec,
            jparams)


@pytest.fixture(scope="module")
def cons():
    return ({"digits": con.compile_regex(DIGITS, VOCAB),
             "obj": con.compile_json_schema(SCHEMA, VOCAB)},
            {"digits": jcon.compile_regex(DIGITS, VOCAB),
             "obj": jcon.compile_json_schema(SCHEMA, VOCAB)})


def _trap(mod):
    """A hand-built 2-state DFA: state 0 admits one token into a trap
    that admits nothing and does not accept (a dead end compiled DFAs
    never have)."""
    tr = np.full((2, 128), -1, np.int32)
    tr[0, 5] = 1
    return mod.TokenDFA(transitions=tr, accepting=np.array([False, False]),
                        pattern="<trap>")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_tables_equal_jax(pattern):
    got = con.compile_regex(pattern, VOCAB)
    want = jcon.compile_regex(pattern, VOCAB)
    np.testing.assert_array_equal(got.transitions, want.transitions)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert got.start == want.start and got.pattern == want.pattern


@pytest.mark.parametrize("schema", SCHEMAS, ids=range(len(SCHEMAS)))
def test_schema_tables_equal_jax(schema):
    assert con.schema_to_regex(schema) == jcon.schema_to_regex(schema)
    got = con.compile_json_schema(schema, VOCAB)
    want = jcon.compile_json_schema(schema, VOCAB)
    np.testing.assert_array_equal(got.transitions, want.transitions)
    np.testing.assert_array_equal(got.accepting, want.accepting)


def test_compiler_errors_match_jax():
    for fn in (lambda m: m.compile_regex("[0-9]#", VOCAB),
               lambda m: m.compile_regex("(ab", VOCAB),
               lambda m: m.schema_to_regex({"type": "tuple"})):
        with pytest.raises(jcon.ConstraintError) as jerr:
            fn(jcon)
        with pytest.raises(con.ConstraintError) as err:
            fn(con)
        assert str(err.value) == str(jerr.value)


def test_stacked_tables_and_mask_fold_equal_jax(cons):
    """The stacked [C, S_max, V] tables, and one mask fold + state
    advance on random logits, equal the JAX runtime's."""
    pcons, jcons = cons
    names, trans, acc = crt.stack_token_dfas(pcons, 128)
    jnames, jtrans, jacc = jcrt.stack_token_dfas(jcons, 128)
    assert names == jnames
    np.testing.assert_array_equal(trans.numpy(), np.asarray(jtrans))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    rng = np.random.default_rng(3)
    cid = np.array([0, 1, 2, 1], np.int32)
    cstate = np.array([0, 0, 1, 1], np.int32)
    ll = rng.standard_normal((4, 128)).astype(np.float32)
    row, a = crt.constrain_rows(trans, acc, torch.from_numpy(cid),
                                torch.from_numpy(cstate))
    jrow, ja = jcrt.constrain_rows(jtrans, jacc, jnp.asarray(cid),
                                   jnp.asarray(cstate))
    mask = crt.constrain_mask(row, a, EOS)
    jmask = jcrt.constrain_mask(jrow, ja, EOS)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    folded = crt.fold_mask(torch.from_numpy(ll), mask)
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(jcrt.fold_mask(jnp.asarray(ll), jmask)))
    nxt = torch.argmax(folded, dim=-1)
    adv = torch.tensor([False, True, True, True])
    np.testing.assert_array_equal(
        crt.advance_state(row, torch.from_numpy(cstate), nxt, adv).numpy(),
        np.asarray(jcrt.advance_state(jrow, jnp.asarray(cstate),
                                      jnp.asarray(nxt.numpy()),
                                      jnp.asarray(adv.numpy()))))
    np.testing.assert_allclose(
        crt.masked_frac(mask, adv).numpy(),
        np.asarray(jcrt.masked_frac(jmask, jnp.asarray(adv.numpy()))),
        rtol=0, atol=1e-7)


def _requests():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 128, size=(1, n)) for n in (3, 4, 2)], [8, 16, 8]


@pytest.mark.parametrize("window", [1, 4])
def test_constrained_greedy_matches_jax(model, cons, window):
    """A digits request, a schema request and a free rider in one batch:
    token-identical to the JAX package's flat server at the same
    decode_window, every output inside its grammar."""
    dec, params, jdec, jparams = model
    pcons, jcons = cons
    prompts, steps = _requests()
    names = ["digits", "obj", None]
    srv = DecodeServer(dec, params, max_batch=4, eos_id=EOS,
                       decode_window=window, constraints=pcons)
    jsrv = JaxDecodeServer(jdec, jparams, max_batch=4, eos_id=EOS,
                           decode_window=window, constraints=jcons)
    rids = [srv.submit(torch.from_numpy(p), s,
                       sampling=SamplingParams(constraint=n) if n else None)
            for p, s, n in zip(prompts, steps, names)]
    jrids = [jsrv.submit(jnp.asarray(p, jnp.int32), s,
                         sampling=JaxSamplingParams(constraint=n)
                         if n else None)
             for p, s, n in zip(prompts, steps, names)]
    done, jdone = srv.run(), jsrv.run()
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(done[r].numpy(),
                                      np.asarray(jdone[jr]))
    dig = detok(done[rids[0]][0, 3:])
    assert re.fullmatch(DIGITS, dig), dig
    obj = detok(done[rids[1]][0, 4:])
    assert json.loads(obj) in ({"ok": True}, {"ok": False})
    assert srv.constrained_tokens_n == jsrv.constrained_tokens_n > 0
    assert srv.constraint_dead_ends_n == 0
    # The free rider equals an unconstrained solo run.
    torch.testing.assert_close(
        done[rids[2]], dec.generate(params, torch.from_numpy(prompts[2]), 8,
                                    eos_id=EOS)[:, :done[rids[2]].shape[1]],
        rtol=0, atol=0)


@pytest.mark.parametrize("window", [1, 4])
def test_dead_end_is_an_error_not_a_hang(model, window):
    """The trap DFA: one admissible token, then a state with no token
    and no accept. The request ends at its last admissible token with an
    error (the forced eos dropped), as in the JAX package; the free
    rider beside it is untouched."""
    dec, params, jdec, jparams = model
    srv = DecodeServer(dec, params, max_batch=2, eos_id=EOS,
                       decode_window=window, constraints={"trap": _trap(con)})
    jsrv = JaxDecodeServer(jdec, jparams, max_batch=2, eos_id=EOS,
                           decode_window=window,
                           constraints={"trap": _trap(jcon)})
    r1 = srv.submit(torch.tensor([[3, 9, 27]]), 8,
                    sampling=SamplingParams(constraint="trap"))
    r2 = srv.submit(torch.tensor([[5]]), 6)
    j1 = jsrv.submit(jnp.asarray([[3, 9, 27]], jnp.int32), 8,
                     sampling=JaxSamplingParams(constraint="trap"))
    jsrv.submit(jnp.asarray([[5]], jnp.int32), 6)
    done, jdone = srv.run(), jsrv.run()
    assert done[r1][0, 3:].tolist() == [5]
    np.testing.assert_array_equal(done[r1].numpy(), np.asarray(jdone[j1]))
    assert srv.errors[r1] == jsrv.errors[j1]
    assert "dead end" in srv.errors[r1]
    assert srv.constraint_dead_ends_n == 1
    torch.testing.assert_close(
        done[r2], dec.generate(params, torch.tensor([[5]]), 6),
        rtol=0, atol=0)


def test_sampled_constrained_stays_in_grammar(model, cons):
    """Temperature > 0 composes with the mask, and a window of 4 equals
    decode_window=1 for the same seed."""
    dec, params, _, _ = model
    outs = []
    for window in (1, 4):
        srv = DecodeServer(dec, params, max_batch=2, eos_id=EOS,
                           decode_window=window, constraints=cons[0])
        r = srv.submit(torch.tensor([[7, 21]]), 10, sampling=SamplingParams(
            temperature=0.9, seed=3, constraint="digits"))
        outs.append(srv.run()[r])
        assert re.fullmatch(DIGITS, detok(outs[-1][0, 2:]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_constraint_validation(model, cons):
    dec, params, _, _ = model
    with pytest.raises(ValueError, match="eos_id"):
        DecodeServer(dec, params, constraints=cons[0])
    srv = DecodeServer(dec, params, eos_id=EOS, constraints=cons[0])
    with pytest.raises(ValueError, match="unknown constraint"):
        srv.submit(torch.tensor([[1]]), 2,
                   sampling=SamplingParams(constraint="nope"))
    stuck = con.TokenDFA(transitions=np.full((1, 128), -1, np.int32),
                         accepting=np.array([False]))
    srv = DecodeServer(dec, params, eos_id=EOS, constraints={"s": stuck})
    with pytest.raises(ValueError, match="no first token"):
        srv.submit(torch.tensor([[1]]), 2,
                   sampling=SamplingParams(constraint="s"))
    with pytest.raises(con.ConstraintError, match="vocab"):
        DecodeServer(dec, params, eos_id=EOS,
                     constraints={"d": con.compile_regex(DIGITS, VOCAB[:64])})
