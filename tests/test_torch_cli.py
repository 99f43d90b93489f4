"""The package CLI, `python -m defer_tpu_torch`: info, partition (the
JAX package's cut list for the same model), roofline on an NVIDIA card's
name, and one serve-stage worker as a subprocess on the CPU, driven over
loopback and checked against the stage's own forward in float32 (atol
1e-5). The subprocess and every thread have timeouts.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from defer_tpu.__main__ import main as jax_main
from defer_tpu_torch.__main__ import main
from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.graph.partition import partition, stage_params
from defer_tpu_torch.runtime.remote_stage import (
    dispatch_stage,
    recv_results,
    send_activation,
)
from defer_tpu_torch.runtime.transport import ArrayReceiver, ArraySender

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_info(capsys):
    main(["info"])
    doc = json.loads(capsys.readouterr().out)
    assert "resnet50" in doc["models"] and "vit_b16" in doc["models"]
    assert doc["num_ops"] > 20
    assert len(doc["devices"]) == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0
    )


def test_partition_prints_the_references_cuts(capsys):
    main(["partition", "vit_tiny", "--stages", "3", "--auto"])
    ours = capsys.readouterr().out.splitlines()
    jax_main(["partition", "vit_tiny", "--stages", "3", "--auto"])
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == theirs[0] and ours[0].startswith("vit_tiny: 3 stages")
    shares = [line.rsplit("(", 1)[1] for line in ours[1:]]
    assert shares == [line.rsplit("(", 1)[1] for line in theirs[1:]]


def test_roofline_on_an_nvidia_card(capsys):
    main(["roofline", "vit_tiny", "--batch", "8", "--device-kind",
          "NVIDIA H100 80GB HBM3", "--top", "2"])
    out = capsys.readouterr().out
    assert out.startswith("roofline[NVIDIA H100 80GB HBM3]")
    assert "(unfused)" in out and "bound:" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device-kind"):
            main(["roofline", "vit_tiny"])


def test_unknown_command_rejected():
    with pytest.raises(SystemExit):
        main(["nope"])


def test_serve_stage_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["serve-stage", "--listen", "0", "--next", "127.0.0.1:1"])


def test_serve_stage_subprocess_on_the_cpu():
    """The reference's node.py, as `python -m defer_tpu_torch serve-stage
    --device cpu`: this process dispatches stage 1, streams stage 0's
    activations, and reads the relayed results."""
    b = GraphBuilder("two_host")
    x = b.input()
    h = b.add("dense", x, name="s0", features=8)
    h = b.add("relu", h, name="s0_relu")
    h = b.add("dense", h, name="s1", features=4)
    g = b.build(h)
    params = g.init(torch.Generator().manual_seed(0), (2, 8))
    st0, st1 = partition(g, ["s0_relu"])
    results = ArrayReceiver(0, host="127.0.0.1", accept_timeout_s=30.0)
    child = subprocess.Popen(
        [sys.executable, "-m", "defer_tpu_torch", "serve-stage",
         "--listen", "0", "--next", f"127.0.0.1:{results.port}",
         "--accept-timeout", "30", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
    )
    try:
        line = child.stdout.readline()
        assert line.startswith("LISTENING "), (line, child.stderr.read())
        send = ArraySender("127.0.0.1", int(line.split()[1]))
        dispatch_stage(send, st1, stage_params(params, st1))
        got: list = []
        t = threading.Thread(target=lambda: got.extend(recv_results(results)),
                             daemon=True)
        t.start()
        xs = [torch.randn(2, 8, generator=torch.Generator().manual_seed(i))
              for i in range(3)]
        for xi in xs:
            send_activation(send, st0.apply(params, xi))
        send.close()
        t.join(timeout=60)
        assert len(got) == 3
        for xi, out in zip(xs, got):
            torch.testing.assert_close(out, g.apply(params, xi), rtol=0,
                                       atol=1e-5)
        out, err = child.communicate(timeout=60)
        assert child.returncode == 0, err
        assert "DONE 3" in out
        stats = json.loads(out.split("STATS ", 1)[1].splitlines()[0])
        assert stats["relayed"] == 3 and set(stats["rx_schemes"]) == {"1"}
        assert 0 < stats["codec_encoded_bytes"] <= stats["codec_raw_bytes"] + 200
    finally:
        child.kill()
        results.close()
