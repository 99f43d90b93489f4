"""The port's speculative decoding and its drafts against the JAX
package's: `DraftLanes.propose`/`propose_c`, `speculative_generate`,
`make_draft` / `draft_width_geometry`, `from_hf_state_dict` and the
weight `transplant` sources.

Weights come from the JAX package's init and cross with
`params_from_jax`; every draft, proposal and greedy continuation must
equal the JAX package's on the same inputs (f32 on the CPU), and
greedy speculation must equal the port's own `generate`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defer_tpu.constrain import compile_regex as jax_compile_regex
from defer_tpu.constrain import runtime as jcrt
from defer_tpu.models import gpt as jgpt
from defer_tpu.models import llama as jllama
from defer_tpu.models import speculative as jspec
from defer_tpu.models import transplant as jtr
from defer_tpu.parallel.transformer_stack import (
    TransformerConfig as JaxTransformerConfig,
)
from defer_tpu.runtime.decode_server import DraftLanes as JaxDraftLanes
from defer_tpu_torch import params_from_jax, params_to_numpy
from defer_tpu_torch.constrain import compile_regex
from defer_tpu_torch.constrain import runtime as crt
from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.models import llama
from defer_tpu_torch.models import transplant as tr
from defer_tpu_torch.models.gpt import GptDecoder
from defer_tpu_torch.models.speculative import speculative_generate
from defer_tpu_torch.parallel.transformer_stack import TransformerConfig
from defer_tpu_torch.runtime.decode_server import DraftLanes

CPU = torch.device("cpu")
TARGET = dict(num_layers=3, dim=64, num_heads=4, ffn_dim=128, vocab_size=96,
              max_len=64, norm_style="pre")
DRAFT = dict(num_layers=1, dim=32, num_heads=2, ffn_dim=64, vocab_size=96,
             max_len=64, norm_style="pre")
LLAMA = dict(num_layers=3, dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
             vocab_size=96, max_len=64)


def _pair(shape, seed, make_cfg=(TransformerConfig, JaxTransformerConfig)):
    jdec = jgpt.GptDecoder(make_cfg[1](**shape), compute_dtype=jnp.float32)
    jparams = jdec.init(jax.random.key(seed))
    dec = GptDecoder(make_cfg[0](**shape), compute_dtype=torch.float32,
                     device=CPU)
    return dec, params_from_jax(jparams, CPU), jdec, jparams


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT, 1)


@pytest.fixture(scope="module")
def llama_target():
    return _pair(LLAMA, 0, (llama.llama_config, jllama.llama_config))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_greedy_matches_jax_and_generate(target, draft, k):
    dec, params, jdec, jparams = target
    ddec, dparams, jddec, jdparams = draft
    prompt = [[5, 17, 3]]
    got, stats = speculative_generate(dec, params, ddec, dparams,
                                      torch.tensor(prompt), 12, k=k)
    want, jstats = jspec.speculative_generate(
        jdec, jparams, jddec, jdparams, jnp.asarray(prompt, jnp.int32), 12,
        k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(
        got, dec.generate(params, torch.tensor(prompt), 12), rtol=0, atol=0)
    assert stats == jstats


def test_perfect_draft_accepts_everything(target):
    """The target as its own draft: every proposal accepted, and the
    target reads its weights about steps / (k + 1) times."""
    dec, params, _, _ = target
    got, stats = speculative_generate(dec, params, dec, params,
                                      torch.tensor([[1, 2]]), 20, k=4)
    torch.testing.assert_close(
        got, dec.generate(params, torch.tensor([[1, 2]]), 20), rtol=0, atol=0)
    assert stats["acceptance"] == 1.0
    assert stats["target_steps"] <= 1 + -(-20 // 5)


def test_llama_target_with_make_draft(llama_target):
    """A GQA rope target and a 1-layer draft carved by make_draft, in
    both packages: equal drafts, equal greedy speculation."""
    dec, params, jdec, jparams = llama_target
    ddec, dparams = tr.make_draft(dec, params, layers=1)
    jddec, jdparams = jtr.make_draft(jdec, jparams, layers=1)
    assert ddec.cfg == dataclasses.replace(ddec.cfg, **{
        f.name: getattr(jddec.cfg, f.name)
        for f in dataclasses.fields(jddec.cfg)})
    prompt = [[7, 1, 30, 2]]
    got, stats = speculative_generate(dec, params, ddec, dparams,
                                      torch.tensor(prompt), 10, k=3)
    want, jstats = jspec.speculative_generate(
        jdec, jparams, jddec, jdparams, jnp.asarray(prompt, jnp.int32), 10,
        k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats


def test_sampled_speculation_is_seeded_and_in_vocab(target, draft):
    dec, params, _, _ = target
    ddec, dparams, _, _ = draft

    def run(seed):
        return speculative_generate(
            dec, params, ddec, dparams, torch.tensor([[5, 17, 3]]), 12, k=3,
            temperature=0.8, top_k=20,
            generator=torch.Generator().manual_seed(seed))

    (a, sa), (b, _) = run(3), run(3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (1, 15) and 0 <= int(a.min()) and int(a.max()) < 96
    assert 0.0 <= sa["acceptance"] <= 1.0


def test_speculative_validation(target, draft):
    dec, params, _, _ = target
    ddec, dparams, _, _ = draft
    with pytest.raises(ValueError, match="batch-1"):
        speculative_generate(dec, params, ddec, dparams,
                             torch.zeros((2, 3), dtype=torch.long), 4)
    with pytest.raises(ValueError, match="k=0"):
        speculative_generate(dec, params, ddec, dparams,
                             torch.zeros((1, 3), dtype=torch.long), 4, k=0)
    with pytest.raises(ValueError, match="max_len"):
        speculative_generate(dec, params, ddec, dparams,
                             torch.zeros((1, 3), dtype=torch.long), 60)


def _lanes_round(lanes, jlanes, prompts, k, constrained=None):
    """Admit `prompts` into both packages' lanes (slot i, lane i), then
    one propose round where slot 0 has lag 1, slot 1 lag 2 (after a full
    accept) and slot 2 is idle."""
    for i, p in enumerate(prompts):
        lanes.admit(i, torch.tensor([p]))
        jlanes.admit(i, jnp.asarray([p], jnp.int32))
    np.testing.assert_array_equal(lanes.pos, jlanes.pos)
    t = [len(p) for p in prompts]
    posm = np.array([t[0] - 1, t[1] - 2, 0, 0], np.int32)
    feed2 = np.array([[prompts[0][-1]] * 2, prompts[1][-2:], [0, 0],
                      [0, 0]], np.int32)
    adv = np.array([1, 2, 0, 0], np.int32)
    if constrained is None:
        return (lanes.propose(k, posm, feed2, adv),
                jlanes.propose(k, posm, feed2, adv))
    (cid, cstate, trans, acc), (jtrans, jacc) = constrained
    return (
        lanes.propose_c(k, posm, feed2, adv, 0, cid, cstate, trans, acc),
        jlanes.propose_c(k, posm, feed2, adv, 0,
                         jnp.asarray(cid.numpy()), jnp.asarray(cstate.numpy()),
                         jtrans, jacc),
    )


def test_draft_lanes_propose_matches_jax(target, draft):
    dec, params, jdec, jparams = target
    ddec, dparams, jddec, jdparams = draft
    lanes = DraftLanes(ddec, dparams, 4)
    jlanes = JaxDraftLanes(jddec, jdparams, 4)
    props, jprops = _lanes_round(lanes, jlanes, [[5, 17, 3], [9, 9, 2, 40],
                                                 [1]], 4)
    np.testing.assert_array_equal(props[:2].numpy(), np.asarray(jprops)[:2])
    np.testing.assert_allclose(lanes.ck.numpy()[:, :2],
                               np.asarray(jlanes.ck)[:, :2], rtol=0,
                               atol=1e-5)
    # A lane's proposals are the draft's own greedy continuation.
    for i, p in enumerate([[5, 17, 3], [9, 9, 2, 40]]):
        want = ddec.generate(dparams, torch.tensor([p]), 4)[0, len(p):]
        assert props[i].tolist() == want.tolist()
    lanes.release(1)
    assert lanes.pos[1] == 0 and not lanes.ck[:, 1].any()
    lanes.release_all()
    assert not lanes.pos.any() and not lanes.ck.any()


def test_draft_lanes_propose_c_matches_jax(target, draft):
    """Constrained proposals: slot 0 under a digits-style DFA over the
    96-token vocabulary, slot 1 free; equal to JAX's propose_c."""
    dec, params, jdec, jparams = target
    ddec, dparams, jddec, jdparams = draft
    vocab = [""] + [str(i % 10) if i < 40 else f"<{i}>" for i in range(1, 96)]
    dfa = compile_regex("[0-9]+", vocab)
    jdfa = jax_compile_regex("[0-9]+", vocab)
    _, trans, acc = crt.stack_token_dfas({"d": dfa}, 96)
    _, jtrans, jacc = jcrt.stack_token_dfas({"d": jdfa}, 96)
    cid = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    cstate = torch.zeros(4, dtype=torch.int32)
    lanes = DraftLanes(ddec, dparams, 4)
    jlanes = JaxDraftLanes(jddec, jdparams, 4)
    props, jprops = _lanes_round(
        lanes, jlanes, [[5, 17, 3], [9, 9, 2, 40], [1]], 3,
        ((cid, cstate, trans, acc), (jtrans, jacc)))
    np.testing.assert_array_equal(props[:2].numpy(), np.asarray(jprops)[:2])
    assert all(1 <= t < 40 for t in props[0].tolist())


def test_draft_lanes_geometry_gates(target):
    dec, params, _, _ = target
    for field, value, match in (("vocab_size", 64, "vocab_size"),
                                ("num_kv_heads", 2, "kv_heads"),
                                ("pos_style", "rope", "pos_style")):
        bad = GptDecoder(dataclasses.replace(dec.cfg, **{field: value}),
                         compute_dtype=torch.float32, device=CPU)
        with pytest.raises(ValueError, match=match):
            DraftLanes(bad, params, 2, target=dec)
    rope = GptDecoder(dataclasses.replace(dec.cfg, pos_style="rope"),
                      compute_dtype=torch.float32, device=CPU)
    theta = GptDecoder(dataclasses.replace(rope.cfg, rope_theta=5e5),
                       compute_dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="rope_theta"):
        DraftLanes(theta, params, 2, target=rope)


@pytest.mark.parametrize("kw", [dict(layers=2), dict(width=0.5),
                                dict(layers=1, width=0.5),
                                dict(layers=2, dtype="int8")],
                         ids=["layers", "width", "both", "int8"])
def test_make_draft_params_match_jax(llama_target, kw):
    dec, params, jdec, jparams = llama_target
    ddec, dparams = tr.make_draft(dec, params, **kw)
    jddec, jdparams = jtr.make_draft(jdec, jparams, **kw)
    for f in ("num_layers", "num_heads", "kv_heads", "dim", "ffn_dim",
              "rope_theta", "max_len", "vocab_size"):
        assert getattr(ddec.cfg, f) == getattr(jddec.cfg, f), f
    got = params_to_numpy(dparams)

    def cmp(g, w, path=""):
        assert g.keys() == w.keys()
        for key in g:
            if isinstance(g[key], dict):
                cmp(g[key], w[key], f"{path}/{key}")
            else:
                np.testing.assert_allclose(g[key], np.asarray(w[key]),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{path}/{key}")

    cmp(got, jdparams)
    ids = torch.tensor([[3, 1, 4, 1, 5]])
    np.testing.assert_allclose(
        ddec.reference_logits(dparams, ids).numpy(),
        np.asarray(jddec.reference_logits(jdparams,
                                          jnp.asarray(ids.numpy()))),
        rtol=0, atol=1e-4)


def test_make_draft_geometry_and_errors(llama_target):
    dec, params, _, _ = llama_target
    for w in (0.1, 0.5, 0.74, 1.0):
        assert tr.draft_width_geometry(dec.cfg, w) == \
            jtr.draft_width_geometry(dec.cfg, w)
    with pytest.raises(tr.TransplantError, match="layers"):
        tr.make_draft(dec, params, layers=0)
    with pytest.raises(tr.TransplantError, match="width"):
        tr.make_draft(dec, params, width=1.5)
    _, q = tr.make_draft(dec, params, layers=1, dtype="int8")
    with pytest.raises(tr.TransplantError, match="quantized"):
        tr.make_draft(dec, q, layers=1)


def _hf_state_dict(cfg, seed, untied):
    """A hand-made HF-keyed Llama state dict of torch tensors."""
    g = torch.Generator().manual_seed(seed)
    D, F, V = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    dkv = cfg.kv_heads * (D // cfg.num_heads)
    sd = {"model.embed_tokens.weight": torch.randn(V, D, generator=g),
          "model.norm.weight": 1 + 0.1 * torch.randn(D, generator=g)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (D, D)),
                            ("self_attn.k_proj", (dkv, D)),
                            ("self_attn.v_proj", (dkv, D)),
                            ("self_attn.o_proj", (D, D)),
                            ("mlp.gate_proj", (F, D)),
                            ("mlp.up_proj", (F, D)),
                            ("mlp.down_proj", (D, F))):
            sd[pre + name + ".weight"] = torch.randn(shape, generator=g) * 0.1
        sd[pre + "input_layernorm.weight"] = 1 + 0.1 * torch.randn(
            D, generator=g)
        sd[pre + "post_attention_layernorm.weight"] = 1 + 0.1 * torch.randn(
            D, generator=g)
    sd["lm_head.weight"] = (torch.randn(V, D, generator=g) if untied
                            else sd["model.embed_tokens.weight"].clone())
    return sd


def test_from_hf_state_dict_defaults_to_the_card():
    """Without a device the params land on the first CUDA device, as the
    JAX package's land on its accelerator; with no card the call raises
    and names the CPU opt-in."""
    cfg = llama.llama_config(**LLAMA)
    sd = _hf_state_dict(cfg, 5, False)
    if torch.cuda.is_available():
        got = llama.from_hf_state_dict(cfg, sd)
        assert got["token_embedding"].device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            llama.from_hf_state_dict(cfg, sd)


@pytest.mark.parametrize("untied", [False, True])
def test_from_hf_state_dict_matches_jax(untied):
    cfg = llama.llama_config(**LLAMA)
    jcfg = jllama.llama_config(**LLAMA)
    sd = _hf_state_dict(cfg, 5, untied)
    got = llama.from_hf_state_dict(cfg, sd, device="cpu")
    want = jllama.from_hf_state_dict(jcfg, sd)
    assert ("lm_head" in got) == ("lm_head" in want) == untied
    got_np = params_to_numpy(got)
    for k in ("token_embedding", "final_ln_scale"):
        np.testing.assert_array_equal(got_np[k], np.asarray(want[k]))
    assert got_np["stack"].keys() == want["stack"].keys()
    for k, v in got_np["stack"].items():
        np.testing.assert_array_equal(v, np.asarray(want["stack"][k]), k)
    dec = GptDecoder(cfg, compute_dtype=torch.float32, device=CPU)
    jdec = jgpt.GptDecoder(jcfg, compute_dtype=jnp.float32)
    ids = np.array([[1, 5, 9, 2, 7, 3]])
    np.testing.assert_allclose(
        dec.reference_logits(got, torch.from_numpy(ids)).numpy(),
        np.asarray(jdec.reference_logits(want, jnp.asarray(ids))),
        rtol=0, atol=1e-4)


def test_torch_state_dict_transplant_matches_torch_forward():
    """A small CNN in torch and in the port's IR: transplanting the
    state_dict (OIHW -> HWIO, depthwise order, linear transpose, BN
    statistics) reproduces torch's own forward, and the JAX package's
    source converts every array the same way."""
    torch.manual_seed(0)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
            self.bn1 = torch.nn.BatchNorm2d(8)
            self.dw = torch.nn.Conv2d(8, 16, 3, padding=1, groups=8)
            self.bn2 = torch.nn.BatchNorm2d(16)
            self.fc = torch.nn.Linear(16, 10)

        def forward(self, x):
            x = torch.relu(self.bn1(self.conv1(x)))
            x = torch.relu(self.bn2(self.dw(x)))
            return self.fc(x.mean(dim=(2, 3)))

    net = Net().train()
    with torch.no_grad():
        net(torch.randn(16, 3, 16, 16))
    net.eval()
    b = GraphBuilder("tiny")
    x = b.input("input")
    x = b.add("conv", x, name="conv1", features=8, kernel_size=3, strides=2,
              padding=((1, 1), (1, 1)), use_bias=True)
    x = b.add("batch_norm", x, name="bn1", eps=1e-5)
    x = b.add("relu", x, name="relu1")
    x = b.add("depthwise_conv", x, name="dw", kernel_size=3,
              padding=((1, 1), (1, 1)), depth_multiplier=2, use_bias=True)
    x = b.add("batch_norm", x, name="bn2", eps=1e-5)
    x = b.add("relu", x, name="relu2")
    x = b.add("global_avg_pool", x, name="gap")
    x = b.add("dense", x, name="fc", features=10)
    graph = b.build(x)
    params = graph.init(torch.Generator().manual_seed(0), (2, 16, 16, 3))
    src = tr.TorchStateDict(net.state_dict())
    loaded = tr.transplant(graph, params, src)
    assert src.keys_used() == src.all_keys()
    xin = np.random.default_rng(3).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(np.transpose(xin, (0, 3, 1, 2))))
        got = graph.apply(loaded, torch.from_numpy(xin))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    jsrc = jtr.TorchStateDict(net.state_dict())
    for node in graph.nodes:
        for p in loaded[node.name]:
            want_np = jsrc.get(node, p, ())
            if want_np is not None:
                np.testing.assert_array_equal(
                    loaded[node.name][p].numpy(), want_np)
    with pytest.raises(tr.TransplantError, match="no weights"):
        tr.transplant(graph, params, tr.KerasWeights({}))
    with pytest.raises(tr.TransplantError, match="shape mismatch"):
        tr.transplant(graph, params, tr.TorchStateDict(
            {**net.state_dict(), "fc.weight": torch.zeros(3, 16)}))


def test_keras_weights_and_tensor_to_numpy_match_jax():
    node = type("N", (), {"name": "dw", "op": "depthwise_conv"})()
    arrays = [np.arange(2 * 2 * 3 * 2, dtype=np.float32).reshape(2, 2, 3, 2),
              np.ones(6, np.float32)]
    got = tr.KerasWeights({"dw": arrays}).get(node, "kernel", ())
    want = jtr.KerasWeights({"dw": arrays}).get(node, "kernel", ())
    np.testing.assert_array_equal(got, want)
    bn = type("N", (), {"name": "bn", "op": "batch_norm"})()
    three = [np.full(4, v, np.float32) for v in (1, 2, 3)]
    for missing in ("scale", "bias"):
        for p in ("scale", "bias", "mean", "var"):
            g = tr.KerasWeights({"bn": three}, bn_missing=missing).get(
                bn, p, ())
            w = jtr.KerasWeights({"bn": three}, bn_missing=missing).get(
                bn, p, ())
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    t = torch.randn(3, 4).to(torch.bfloat16)
    np.testing.assert_array_equal(tr.tensor_to_numpy(t),
                                  jtr.tensor_to_numpy(t))
