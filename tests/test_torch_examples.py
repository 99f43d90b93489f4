"""The port's example drivers (defer_tpu_torch/examples/) against the JAX
package, in process, at tiny sizes on the CPU.

Each driver's `run(args, params=, compute_dtype=)` takes weights drawn
by the JAX package's init and carried over through numpy
(`params_from_jax`), in float32; its inputs (prompts, batches, q/k/v)
come back in its result, and the same inputs go through the JAX
package's counterpart. Stated tolerances: a pipeline's outputs within
rtol 1e-4 / atol 1e-6 of `defer_tpu`'s run_defer (float32, the same
ops summed in other orders; the image feed's bf16 inputs within one
bf16 step of the JAX feed's, so its outputs within atol 2e-3); greedy
tokens and served outputs identical; sequence-parallel attention within
0.05 of `defer_tpu`'s attention_reference (the JAX example's bound, on
bf16 q/k/v); first-step training losses within rtol 1e-5 of the JAX
trainers'. The multi-rank launches are in test_torch_examples_slow.py.
"""

import ast
import functools
import os
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import defer_tpu
from defer_tpu.models import get_model as jax_get_model
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.examples import MODULES
from defer_tpu_torch.examples import distributed_infer, finetune_lora
from defer_tpu_torch.examples import generate, local_infer, long_context
from defer_tpu_torch.examples import pretrained_infer, serve_decode
from defer_tpu_torch.examples import spmd_train

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
PIPE_TOL = dict(rtol=1e-4, atol=1e-6)


def _args(module, *argv):
    return module.parser().parse_args([*argv, "--device", "cpu"])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_like(shapes, seed=0):
    """numpy draws in the shapes of a jax.eval_shape tree (nothing is
    compiled or run for a JAX init): norm scales near 1, the rest
    0.05 * N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        a = rng.standard_normal(s.shape) * (0.1 if "scale" in
                                            jax.tree_util.keystr(path)
                                            else 0.05)
        return (a + ("scale" in jax.tree_util.keystr(path))).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_train_state(params, optimizer):
    """A JAX TrainState over numpy params, as init_state builds one."""
    from defer_tpu.parallel.train import TrainState

    params = jax.tree_util.tree_map(jnp.asarray, params)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=jnp.zeros((), jnp.int32))


# -- local_infer / distributed_infer ----------------------------------------


@pytest.fixture(scope="module")
def vit():
    """vit_tiny (32x32 inputs): the JAX model, numpy weights in the shapes
    of its init (jax.eval_shape: nothing is compiled for it), its second
    cut candidate, the batch-2 inputs of each feed ("synthetic": ones;
    "images": the first two of examples/images through the JAX feed, in
    float32 for local_infer, in bf16 as the pipeline's feed casts them)
    and defer_tpu's run_defer outputs for them, from one float32 run on
    that cut: the same ops whichever stage boundary a port run uses."""
    jmodel = jax_get_model("vit_tiny")
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    rng = np.random.default_rng(0)
    weights = {
        node: {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
               for k, s in leaves.items()}
        for node, leaves in shapes.items()
    }
    xs = {"synthetic": np.ones((2, *jmodel.input_shape), np.float32),
          "images": _jax_images(jmodel, 2, jnp.float32),
          "images_bf16": _jax_images(jmodel, 2, jnp.bfloat16)}
    cut = jmodel.cut_candidates[1]
    want = dict(zip(xs, _jax_run_defer(jmodel, weights, [cut],
                                       list(xs.values()))))
    return jmodel, weights, cut, xs, want


def _jax_run_defer(jmodel, weights, cuts, xs):
    """defer_tpu's run_defer in float32 over the inputs, in order."""
    defer = defer_tpu.DEFER(
        config=defer_tpu.DeferConfig(compute_dtype=jnp.float32))
    inq, outq = queue.Queue(), queue.Queue()
    t = threading.Thread(target=defer.run_defer,
                         args=(jmodel, cuts, inq, outq),
                         kwargs={"params": weights}, daemon=True)
    t.start()
    for x in xs:
        inq.put(jnp.asarray(x))
    inq.put(None)
    outs = [np.asarray(outq.get(timeout=120), np.float32) for _ in xs]
    t.join(timeout=60)
    return outs


def _jax_images(jmodel, batch, dtype):
    """The first `batch` images of examples/images through the JAX
    package's feed (load_image_dir, imagenet_preprocess)."""
    from defer_tpu.runtime import data as jdata

    imgs = list(jdata.load_image_dir(os.path.join(REPO, "examples",
                                                  "images")))[:batch]
    return np.concatenate([
        np.asarray(jdata.imagenet_preprocess(
            im, size=jmodel.input_shape[0],
            mode=jdata.preprocess_mode(jmodel.name), out_dtype=dtype),
            np.float32)
        for im in imgs])


@pytest.mark.parametrize("feed", ["synthetic", "images"])
def test_local_infer_matches_jax_run_defer(vit, feed):
    jmodel, weights, _, _, want = vit
    argv = ["--model", "vit_tiny", "--minutes", "0.001", "--batch", "2"]
    if feed == "synthetic":
        argv.append("--synthetic")
    res = local_infer.run(_args(local_infer, *argv),
                          params=params_from_jax(weights, CPU),
                          compute_dtype=F32)
    assert res["count"] >= 1 and res["items_per_sec"] > 0
    np.testing.assert_allclose(res["output"].numpy(), want[feed],
                               **PIPE_TOL)


@pytest.mark.parametrize("feed", ["synthetic", "images"])
def test_distributed_infer_matches_jax_run_defer(vit, feed, capsys):
    """Two stages on the CPU (--cuts), the first result of the stream
    against the JAX run_defer on the same cut and input."""
    jmodel, weights, cut, _, want = vit
    argv = ["--model", "vit_tiny", "--minutes", "0.002", "--batch", "2",
            "--cuts", cut]
    if feed == "synthetic":
        argv.append("--synthetic")
        tol = PIPE_TOL
    else:
        # The feed casts each image to bf16 on the host, as the JAX one.
        feed = "images_bf16"
        tol = dict(rtol=0, atol=2e-3)
    res = distributed_infer.run(_args(distributed_infer, *argv),
                                params=params_from_jax(weights, CPU),
                                compute_dtype=F32)
    out = capsys.readouterr().out
    assert res["stages"] == 2 and res["count"] >= 1
    assert "vit_tiny: 2 stages over 1 device(s)" in out
    assert "images/sec" in out and "Throughput: " in out
    np.testing.assert_allclose(res["first_output"].float().numpy(),
                               want[feed], **tol)


def test_distributed_infer_without_pil_names_synthetic(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL"
                        else real(name, *a))
    with pytest.raises(RuntimeError, match="--synthetic"):
        distributed_infer.run(_args(distributed_infer, "--model",
                                    "vit_tiny", "--minutes", "0.001"))


# -- generate ---------------------------------------------------------------

DECODER = ["--layers", "2", "--dim", "64", "--heads", "4", "--ffn", "128",
           "--vocab", "96", "--max-len", "64"]


def _jax_config(args):
    """The JAX package's config for a driver's flags."""
    from defer_tpu.models.llama import llama_config
    from defer_tpu.parallel.transformer_stack import TransformerConfig

    kv = getattr(args, "kv_heads", None)
    if args.family == "llama":
        return llama_config(
            num_layers=args.layers, dim=args.dim, num_heads=args.heads,
            num_kv_heads=kv or max(1, args.heads // 4), ffn_dim=args.ffn,
            vocab_size=args.vocab, max_len=args.max_len)
    return TransformerConfig(
        num_layers=args.layers, dim=args.dim, num_heads=args.heads,
        num_kv_heads=kv, ffn_dim=args.ffn, vocab_size=args.vocab,
        max_len=args.max_len, norm_style="pre")


@functools.lru_cache(maxsize=None)
def _jax_decoder(cfg):
    """A float32 JAX GptDecoder for a config, with numpy weights in the
    shapes of its init and those weights as JAX arrays: one a config, so
    the tests of one config share its compiled steps."""
    from defer_tpu.models.gpt import GptDecoder as JaxGptDecoder

    jdec = JaxGptDecoder(cfg, compute_dtype=jnp.float32)
    weights = _numpy_like(jax.eval_shape(jdec.init, jax.random.key(0)))
    return jdec, weights, jax.tree_util.tree_map(jnp.asarray, weights)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_greedy_tokens_equal_jax(family, capsys):
    """The driver's greedy loop against the JAX GptDecoder's step loop on
    the same weights and prompt: identical tokens; --speculate 2's
    greedy output equals the plain loop's (exact in float32)."""

    args = _args(generate, *DECODER, "--family", family, "--prompt-len",
                 "8", "--steps", "6", "--speculate", "2")
    jdec, weights, jparams = _jax_decoder(_jax_config(args))
    res = generate.run(args, params=params_from_jax(weights, CPU),
                       compute_dtype=F32)
    out = capsys.readouterr().out
    assert "single-device decode" in out and "steady decode" in out
    assert "speculative (k=2" in out

    step = jdec.make_step()
    cache = jdec.init_cache(1)
    logits, cache = step(jparams, cache,
                         jnp.asarray(res["prompt"].numpy(), jnp.int32))
    want = []
    for _ in range(args.steps + 1):
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(nxt))
        logits, cache = step(jparams, cache, nxt)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(want, axis=1))
    spec = res["speculative"]["ids"][:, args.prompt_len:]
    np.testing.assert_array_equal(spec.numpy(),
                                  res["tokens"][:, : args.steps].numpy())


def test_generate_rep_penalty_greedy_equals_jax(capsys):
    """--rep-penalty 1.5 at temperature 0: the driver's penalised greedy
    loop against the JAX GptDecoder's step loop through defer_tpu's
    seen_tokens_mask and repetition_penalty: identical tokens."""
    from defer_tpu.models.gpt import repetition_penalty, seen_tokens_mask

    args = _args(generate, *DECODER, "--prompt-len", "8", "--steps", "6",
                 "--rep-penalty", "1.5")
    jdec, weights, jparams = _jax_decoder(_jax_config(args))
    res = generate.run(args, params=params_from_jax(weights, CPU),
                       compute_dtype=F32)
    assert "steady decode" in capsys.readouterr().out

    prompt = jnp.asarray(res["prompt"].numpy(), jnp.int32)
    step = jdec.make_step()
    logits, cache = step(jparams, jdec.init_cache(1), prompt)
    seen = seen_tokens_mask(prompt, args.vocab)
    want = []
    for _ in range(args.steps + 1):
        lg = repetition_penalty(logits[:, -1], seen, args.rep_penalty)
        nxt = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        seen = seen.at[0, nxt[0, 0]].set(True)
        want.append(np.asarray(nxt))
        logits, cache = step(jparams, cache, nxt)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(want, axis=1))


def test_generate_sampling_draws_from_the_filtered_set(capsys):
    """--temperature 0.8 --top-k 4 with --speculate 2: the same seeds
    draw the same tokens, and every token of the plain loop and of the
    speculative run is among the top 4 of its teacher-forced row."""
    from defer_tpu_torch.models.gpt import GptDecoder

    args = _args(generate, *DECODER, "--prompt-len", "8", "--steps", "8",
                 "--temperature", "0.8", "--top-k", "4", "--speculate", "2")
    dec = GptDecoder(generate.config(args), compute_dtype=F32, device=CPU)
    params = dec.init(torch.Generator().manual_seed(3))
    runs = [generate.run(args, params=params, compute_dtype=F32)
            for _ in range(2)]
    assert "speculative (k=2" in capsys.readouterr().out
    first, again = runs
    assert torch.equal(first["tokens"], again["tokens"])
    assert torch.equal(first["speculative"]["ids"],
                       again["speculative"]["ids"])
    plen = args.prompt_len
    for ids in (torch.cat([first["prompt"], first["tokens"]], dim=1),
                first["speculative"]["ids"]):
        rows = dec.reference_logits(params, ids[:, :-1])[0, plen - 1:]
        top = rows.topk(args.top_k, dim=-1).indices
        assert (top == ids[0, plen:, None]).any(-1).all(), ids


def test_generate_length_guard_and_tp_without_a_group(monkeypatch):
    with pytest.raises(SystemExit, match="exceeds --max-len"):
        generate.run(_args(generate, *DECODER, "--prompt-len", "60"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        generate.run(_args(generate, *DECODER, "--steps", "4", "--tp", "2"))


# -- serve_decode -----------------------------------------------------------


def test_serve_decode_check_and_outputs_equal_jax(capsys):
    """--check and --stop-demo pass; every request's output equals the
    JAX DecodeServer's on the same weights, prompts and slots."""
    from defer_tpu.runtime.decode_server import DecodeServer

    args = _args(serve_decode, *DECODER[:-2], "--max-len", "128",
                 "--requests", "4", "--slots", "2", "--check",
                 "--stop-demo")
    jdec, weights, jparams = _jax_decoder(_jax_config(args))
    res = serve_decode.run(args, params=params_from_jax(weights, CPU),
                           compute_dtype=F32)
    out = capsys.readouterr().out
    assert "valid greedy choices" in out and "terminated request 0" in out
    assert res["checked"] == sum(s for _, s in res["requests"])

    srv = DecodeServer(jdec, jparams, max_batch=args.slots)
    rids = [srv.submit(jnp.asarray(p.numpy(), jnp.int32), s)
            for p, s in res["requests"]]
    done = srv.run()
    for rid, got in zip(rids, res["outputs"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(done[rid]))
    assert (res["ticks"], res["solo_steps"]) == (srv.ticks, srv.solo_steps)


@pytest.mark.parametrize("flag", ["--prefix", "--adapters"])
def test_serve_decode_prefix_and_adapters_equal_jax(flag, capsys):
    """--prefix 6 (with --stop-demo) and --adapters 2 under --check: every
    request's output equals the JAX DecodeServer's on the same weights,
    prompts, shared prefix and adapter banks (the driver's random
    adapters carried over through numpy and stacked by defer_tpu's
    stack_adapters)."""
    import dataclasses

    from defer_tpu.parallel.lora import stack_adapters
    from defer_tpu.runtime.decode_server import DecodeServer
    from defer_tpu_torch import params_to_numpy

    extra = (["--prefix", "6", "--stop-demo"] if flag == "--prefix"
             else ["--adapters", "2"])
    args = _args(serve_decode, *DECODER[:-2], "--max-len", "128",
                 "--requests", "4", "--slots", "2", "--check", *extra)
    jcfg = _jax_config(args)
    jdec, weights, jparams = _jax_decoder(jcfg)
    res = serve_decode.run(args, params=params_from_jax(weights, CPU),
                           compute_dtype=F32)
    out = capsys.readouterr().out
    assert "valid greedy choices" in out
    adapter_of = lambda i: 0  # noqa: E731
    prefix = None
    if flag == "--prefix":
        assert "prefill tokens reused" in out
        assert "terminated request 0" in out
        prefix = jnp.asarray(res["prefix"].numpy(), jnp.int32)
    else:
        _, trees = serve_decode.adapter_trees(serve_decode.config(args),
                                              args.adapters, CPU)
        lora = dataclasses.replace(jcfg, lora_rank=8, lora_alpha=16.0,
                                   lora_targets=("wq", "wv"))
        jparams = stack_adapters(
            jparams, [jax.tree_util.tree_map(jnp.asarray,
                                             params_to_numpy(t))
                      for t in trees], lora)
        adapter_of = lambda i: i % (args.adapters + 1)  # noqa: E731
    # --check covers the base-model requests (reference_logits carries
    # no adapter id).
    assert res["checked"] == sum(s for i, (_, s) in
                                 enumerate(res["requests"])
                                 if adapter_of(i) == 0)

    srv = DecodeServer(jdec, jparams, max_batch=args.slots,
                       prefix_ids=prefix)
    rids = [srv.submit(jnp.asarray(p.numpy(), jnp.int32), s,
                       adapter_id=adapter_of(i))
            for i, (p, s) in enumerate(res["requests"])]
    done = srv.run()
    for rid, got in zip(rids, res["outputs"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(done[rid]))
    assert (res["ticks"], res["solo_steps"]) == (srv.ticks, srv.solo_steps)


# -- long_context -----------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_long_context_one_process_within_bound_of_jax(causal, capsys):
    from defer_tpu.ops.attention import attention_reference

    argv = ["--seq", "128", "--heads", "2", "--head-dim", "16", "--check"]
    res = long_context.run(_args(long_context,
                                 *argv, *(["--causal"] if causal else [])))
    assert "matches unsharded reference" in capsys.readouterr().out
    want = attention_reference(
        *(jnp.asarray(res[n].float().numpy()) for n in "qkv"),
        causal=causal)
    err = np.abs(res["out"].float().numpy() - np.asarray(want)).max()
    assert err < 0.05, err


# -- spmd_train / finetune_lora ---------------------------------------------


SPMD_TINY = ["--tp", "1", "--layers", "2", "--dim", "32", "--seq", "16",
             "--steps", "4"]


@pytest.fixture(scope="module")
def spmd_plain(devices):
    """The JAX trainer on {"data": 1, "stage": 2, "model": 1}, numpy
    weights in the shapes of its init, and the driver's plain --tp 1
    --stages 2 run on those weights in float32."""
    from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
    from defer_tpu.parallel import mesh as jmesh
    from defer_tpu.parallel import train as jtrain
    from defer_tpu.parallel.transformer_stack import TransformerConfig

    cfg = TransformerConfig(num_layers=2, dim=32, num_heads=4, ffn_dim=128,
                            vocab_size=1024, max_len=16)
    jsb = JaxSpmdBert(
        jmesh.make_mesh({"data": 1, "stage": 2, "model": 1}, devices[:2]),
        cfg, compute_dtype=jnp.float32)
    jinit, jstep = jtrain.make_train_step(jsb, optax.adamw(1e-3),
                                          num_classes=8)
    weights = _numpy_like(jax.eval_shape(jinit, jax.random.key(0)).params)
    res = spmd_train.run(_args(spmd_train, *SPMD_TINY),
                         params=params_from_jax(weights, CPU),
                         compute_dtype=F32)
    return jstep, weights, res


def test_spmd_train_first_loss_matches_jax_and_drops(spmd_plain):
    """--tp 1 --stages 2 in one process against the JAX trainer on the
    same weights (numpy draws in the shapes of its init) and batch: the
    first step's loss; the loss drops."""
    jstep, weights, res = spmd_plain
    jstate = _jax_train_state(weights, optax.adamw(1e-3))
    ids, labels = res["first_batch"]
    _, want = jstep(jstate, jnp.asarray(ids.numpy(), jnp.int32),
                    jnp.asarray(labels.numpy(), jnp.int32))
    np.testing.assert_allclose(res["losses"][0], float(want), rtol=1e-5)
    assert res["losses"][-1] < res["losses"][0], res["losses"]


def test_spmd_train_remat_and_zero1_keep_the_losses(spmd_plain):
    """--remat --zero1 in one process: recomputed blocks and (over a data
    axis of 1) unsplit moments give the plain run's losses, step for
    step; --fsdp and a split --zero1 need a data axis, on ranks
    (test_torch_examples_slow.py)."""
    _, weights, plain = spmd_plain
    res = spmd_train.run(_args(spmd_train, *SPMD_TINY, "--remat",
                               "--zero1"),
                         params=params_from_jax(weights, CPU),
                         compute_dtype=F32)
    np.testing.assert_allclose(res["losses"], plain["losses"], rtol=1e-6)


def test_spmd_train_lm_serves_the_trained_tree(capsys):
    """--lm: the causal stack trains (finite losses) and its gathered,
    unstacked tree serves greedy tokens on GptDecoder."""
    res = spmd_train.run(_args(spmd_train, *SPMD_TINY[:-1], "2", "--lm"),
                         compute_dtype=F32)
    out = capsys.readouterr().out
    assert "served 8 greedy tokens of the trained tree on GptDecoder" in out
    assert res["served"] == 8 and np.isfinite(res["losses"]).all()


def test_finetune_lora_first_loss_matches_jax(devices, capsys):
    """{"stage": 1} in one process against the JAX LoRA trainer on the
    same base, adapters, head and batch: the first step's loss; the
    driver's own asserts (loss drops, merged accuracy > 0.5) hold."""
    from defer_tpu.models.bert import SpmdBert as JaxSpmdBert
    from defer_tpu.parallel import lora as jlora
    from defer_tpu.parallel import mesh as jmesh
    from defer_tpu.parallel.transformer_stack import TransformerConfig

    args = _args(finetune_lora, "--layers", "2", "--dim", "32", "--heads",
                 "4", "--ffn", "64", "--vocab", "96", "--rank", "4",
                 "--steps", "8")
    cfg = TransformerConfig(num_layers=2, dim=32, num_heads=4, ffn_dim=64,
                            vocab_size=96, max_len=64, lora_rank=4,
                            lora_alpha=16.0,
                            lora_targets=("wq", "wv", "w1", "w2"))
    jsb = JaxSpmdBert(jmesh.make_mesh({"stage": 1}, devices[:1]), cfg,
                      compute_dtype=jnp.float32)
    jinit, jstep = jlora.make_lora_train_step(jsb, optax.adam(1e-2),
                                              num_classes=4)
    state_shapes, base_shapes = jax.eval_shape(jinit, jax.random.key(0))
    trainable = _numpy_like(state_shapes.params, seed=1)
    base = _numpy_like(base_shapes)
    jstate = _jax_train_state(trainable, optax.adam(1e-2))
    jbase = jax.tree_util.tree_map(jnp.asarray, base)
    whole = {**jlora.combine_lora(base, trainable),
             "cls_w": trainable["cls_w"], "cls_b": trainable["cls_b"]}
    res = finetune_lora.run(args, params=params_from_jax(whole, CPU))
    assert "finetune_lora OK" in capsys.readouterr().out
    ids, labels = res["batch"]
    _, want = jstep(jstate, jbase, jnp.asarray(ids.numpy(), jnp.int32),
                    jnp.asarray(labels.numpy(), jnp.int32))
    np.testing.assert_allclose(res["losses"][0], float(want), rtol=1e-5)
    assert res["accuracy"] > 0.5


# -- pretrained_infer -------------------------------------------------------


def test_pretrained_infer_skips_offline(capsys):
    """No checkpoint file: the SKIP line and exit code 0, as the JAX
    example's offline contract."""
    code = pretrained_infer.main(["--weights", "/nonexistent.h5",
                                  "--device", "cpu"])
    assert code == 0
    assert "SKIP: pretrained weights unavailable" in capsys.readouterr().out


# -- the surface ------------------------------------------------------------


def _arguments(path):
    """{flag: its literal default, or "?" where it is an expression}
    of every add_argument call in a module."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            try:
                default = ast.literal_eval(kw["default"]) if "default" in kw \
                    else None
            except ValueError:
                default = "?"
            out[node.args[0].value] = default
    return out


@pytest.mark.parametrize("name", MODULES)
def test_flags_are_a_superset_of_the_jax_example(name):
    """Every add_argument name of examples/<name>.py is the port
    module's, with the same default; the port adds only --device
    ("cuda"), and --images points at examples/images."""
    want = _arguments(os.path.join(REPO, "examples", f"{name}.py"))
    got = _arguments(os.path.join(REPO, "defer_tpu_torch", "examples",
                                  f"{name}.py"))
    assert got == want
    module = __import__(f"defer_tpu_torch.examples.{name}",
                        fromlist=["parser"])
    parser = module.parser()
    flags = {s for a in parser._actions for s in a.option_strings}
    assert flags == set(want) | {"--device", "-h", "--help"}
    parsed = parser.parse_args([])
    assert parsed.device == "cuda"
    if "--images" in want:
        assert os.path.samefile(parsed.images,
                                os.path.join(REPO, "examples", "images"))


@pytest.mark.parametrize("name", MODULES)
def test_modules_import_neither_jax_nor_defer_tpu(name):
    path = os.path.join(REPO, "defer_tpu_torch", "examples", f"{name}.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots = {(node.module or "").split(".")[0]}
        else:
            continue
        assert not roots & {"jax", "defer_tpu"}, (name, roots)
    assert "sys.path" not in open(path).read()


def test_drivers_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_infer.run(local_infer.parser().parse_args(["--synthetic"]))
