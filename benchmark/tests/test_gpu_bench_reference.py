"""The plain references against the program's graph on the same weights,
in float32 on the CPU, and the control's precision against the
program's: the program in bfloat16 stays under the cells' limits where
the reference in fp8 does not."""

import pytest
import torch

from benchmark import compare, harness, lowprec, weights

CONFIGS = ("resnet50", "vit_b16")
SEED = 2**31 + 11


def _setup(name, batch):
    from defer_tpu_torch.models import get_model

    cfg = harness.load_json("configs", f"{name}.json")
    ref = harness.load_module("reference", name)
    w = weights.draw(ref.param_specs(cfg), cfg["init"], SEED,
                     torch.device("cpu"), torch.bfloat16)
    model = get_model(cfg["program_model"])
    x = weights.input_entries(SEED, 1, (batch, *model.input_shape),
                              torch.device("cpu"))[0]
    return cfg, ref, w, model, x


def _program(model, w, x, dtype):
    from defer_tpu_torch.config import DeferConfig
    from defer_tpu_torch.parallel.pipeline import Pipeline

    pipe = Pipeline([model.graph], weights.as_tree(w), [torch.device("cpu")],
                    DeferConfig(compute_dtype=dtype))
    with torch.inference_mode():
        return pipe(x)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_programs_function(name):
    cfg, ref, w, model, x = _setup(name, 2)
    expected = ref.forward(cfg, w, x)
    got = _program(model, w, x, torch.float32)
    assert got.shape == expected.shape
    assert float(compare.row_errors(got, expected, cfg["output"]).max()) < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_cover_the_programs_params(name):
    """Every leaf the program's graph holds is drawn, at its shape."""
    cfg, ref, _, model, _ = _setup(name, 1)
    drawn = {n: tuple(s) for n, s, _ in ref.param_specs(cfg)}
    own = model.init(torch.Generator().manual_seed(0))
    want = {f"{node}.{leaf}": tuple(t.shape)
            for node, leaves in own.items() for leaf, t in leaves.items()}
    assert drawn == want


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_where_the_program_passes(name):
    """At batch 1 on the CPU: the bfloat16 program reads well under the
    limit of each of the config's cells, the fp8 reference over it."""
    cfg, ref, w, model, x = _setup(name, 1)
    expected = ref.forward(cfg, w, x)
    program = float(compare.row_errors(
        _program(model, w, x, torch.bfloat16), expected, cfg["output"]).max())
    control = float(compare.row_errors(
        ref.forward(cfg, w, x, quantize=lowprec.fp8), expected,
        cfg["output"]).max())
    limits = [harness.load_json("workloads", f"{c['name']}.json")["check"]["limit"]
              for c in harness.benchmark_spec()["workloads"]
              if c["config"] == name]
    assert limits
    for limit in limits:
        assert program < limit < control


def test_weights_same_for_the_same_seed_and_not_for_another():
    cfg = harness.load_json("configs", "resnet50.json")
    specs = harness.load_module("reference", "resnet50").param_specs(cfg)[:8]
    a = weights.draw(specs, cfg["init"], 5, torch.device("cpu"), torch.bfloat16)
    b = weights.draw(specs, cfg["init"], 5, torch.device("cpu"), torch.bfloat16)
    c = weights.draw(specs, cfg["init"], 6, torch.device("cpu"), torch.bfloat16)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["conv1_conv.kernel"], c["conv1_conv.kernel"])
    assert float(a["conv1_bn.var"].float().min()) > 0


def test_compare_reads_softmax_as_logits():
    z = torch.randn(3, 10)
    p = torch.softmax(z, -1)
    assert float(compare.row_errors(p, p, "probabilities").max()) == 0.0
    shifted = torch.softmax(z + 0.1 * torch.randn(3, 10), -1)
    e = compare.row_errors(shifted, p, "probabilities")
    assert float(e.min()) > 0.0
    assert float(compare.row_errors(z + 3.0, z, "logits").max()) < 1e-6
