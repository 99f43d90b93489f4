"""The port's example drivers the way a user runs them: fresh
interpreters, real argv, tiny configs on the CPU. The multi-rank drivers
start under torchrun (`python -m torch.distributed.run`) as gloo CPU
ranks; pretrained_infer --weights random builds a real tf.keras ResNet50
(skipped without tensorflow and h5py). Slow-marked: each leg spawns
ranks or imports tensorflow."""

import importlib.util
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
DECODER = ["--layers", "2", "--dim", "64", "--heads", "4", "--ffn", "128",
           "--vocab", "96", "--max-len", "64"]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(module, *argv, ranks=None, timeout=420):
    cmd = [sys.executable]
    if ranks:
        cmd += ["-m", "torch.distributed.run", "--nproc-per-node",
                str(ranks), "--master-addr", "127.0.0.1", "--master-port",
                str(_port())]
    cmd += ["-m", f"defer_tpu_torch.examples.{module}", *argv,
            "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=ENV, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def test_generate_tp2_over_two_ranks():
    out = _run("generate", *DECODER, "--prompt-len", "8", "--steps", "4",
               "--tp", "2", ranks=2)
    assert "tensor-parallel decode over 2 ranks" in out
    assert out.count("steady decode") == 1  # rank 0 alone prints


def test_long_context_two_ranks_checked():
    out = _run("long_context", "--seq", "256", "--heads", "4", "--check",
               ranks=2)
    assert "over 2 ranks" in out and "matches unsharded reference" in out


def test_spmd_train_four_ranks_saves_and_resumes(tmp_path):
    """The defaults' mesh (--stages 2 --tp 2, data = 1) on 4 ranks: a
    sharded checkpoint every 2 steps, then a second run resumes it."""
    argv = ["--layers", "2", "--dim", "32", "--seq", "16", "--steps", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = _run("spmd_train", *argv, ranks=4)
    assert "mesh dp=1 pp=2 tp=2" in out
    assert "saved sharded checkpoint at step 1" in out
    assert "resumed" not in out
    assert len(list(tmp_path.glob("shards-*-of-00004.defer"))) == 4
    out = _run("spmd_train", *argv, ranks=4)
    assert f"resumed sharded state from {tmp_path}" in out
    assert "tokens/sec over 2 steps" in out


def test_spmd_train_zero1_fsdp_remat_over_a_data_axis():
    """--stages 1 --tp 1 on 2 ranks (data = 2): --zero1 --fsdp --remat
    split the moments and the stack weights over the data axis and
    recompute blocks, and print the plain run's losses."""
    argv = ["--stages", "1", "--tp", "1", "--layers", "2", "--dim", "32",
            "--seq", "16", "--steps", "3"]
    plain = _run("spmd_train", *argv, ranks=2)
    split = _run("spmd_train", *argv, "--zero1", "--fsdp", "--remat",
                 ranks=2)
    assert "mesh dp=2 pp=1 tp=1" in plain

    def losses(out):
        return [line for line in out.splitlines() if line.startswith("step")]

    assert len(losses(plain)) == 2 and losses(split) == losses(plain)


def test_finetune_lora_fsdp_four_ranks():
    out = _run("finetune_lora", "--layers", "2", "--dim", "32", "--heads",
               "4", "--ffn", "64", "--vocab", "96", "--rank", "4",
               "--steps", "15", "--fsdp", ranks=4)
    assert "mesh={'data': 2, 'stage': 2}, base FSDP-sharded" in out
    assert "finetune_lora OK" in out


def test_a_multi_rank_flag_without_torchrun_names_it():
    proc = subprocess.run(
        [sys.executable, "-m", "defer_tpu_torch.examples.generate", "--tp",
         "2", "--device", "cpu"], cwd=REPO,
        env={k: v for k, v in ENV.items() if k != "WORLD_SIZE"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torchrun --nproc-per-node 2" in proc.stderr


@pytest.mark.skipif(
    importlib.util.find_spec("tensorflow") is None
    or importlib.util.find_spec("h5py") is None,
    reason="needs tensorflow and h5py")
def test_pretrained_infer_random_weights_agree_with_tf_keras():
    """--weights random: a tf.keras ResNet50 with fresh weights (nothing
    is downloaded), transplanted; single == pipeline == tf.keras on
    top-1 over examples/images."""
    out = _run("pretrained_infer", "--weights", "random", timeout=600)
    assert "OK: 4 images, 2-stage pipeline" in out
    assert "top-1 agreement single==pipeline==tf.keras" in out
