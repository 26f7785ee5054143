"""The port's CLIs (``repro_torch.launch.train``, ``repro_torch.launch.serve``)
run end to end as subprocesses at smoke scale on the CPU (``--device
cpu``): ``tests/test_launchers.py``'s three runs on the port, the c2dfb
run's printed wire bytes against the reference's count, the refusal of
``--device cuda`` without a card, and (in process) the c2dfb CLI's
telemetry records and checkpoint.

About 50 s on one worker."""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs on several
    workers sharing the machine's cores, where torch's own thread pool
    (one thread a core) oversubscribes them and its small operators run
    several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"  # torch's intra-op threads, as `_one_torch_thread` sets them in process
    return subprocess.run([sys.executable] + args, capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)


def test_train_cli_adamw(tmp_path):
    res = _run(["-m", "repro_torch.launch.train", "--arch", "phi3-mini-3.8b", "--smoke", "--algo", "adamw",
                "--steps", "3", "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "loss" in res.stdout
    assert any(f.endswith(".msgpack.zst") for f in os.listdir(tmp_path))


def _reference_wire_line(arch: str, m: int, K: int, lr: float) -> str:
    """The reference launcher's wire-bytes line for these arguments, from
    its own analytic count on its own initial state's shapes."""
    from repro.configs import get_config
    from repro.core.c2dfb import C2DFBConfig, round_wire_bytes
    from repro.core.lm_bilevel import init_node_params
    from repro.core.topology import make_topology

    cfg = dataclasses.replace(get_config(arch, smoke=True), tie_embeddings=False)
    x0, y0 = init_node_params(cfg, jax.random.PRNGKey(0), m)
    state = types.SimpleNamespace(x=x0, inner_y=types.SimpleNamespace(d=y0), inner_z=types.SimpleNamespace(d=y0))
    ccfg = C2DFBConfig(lam=10.0, eta_out=lr, gamma_out=0.5, eta_in=lr * 3, gamma_in=0.5, K=K)
    wire = round_wire_bytes(state, ccfg, make_topology("ring", m))
    return f"[c2dfb] wire bytes/round: {wire['total_bytes']/1e6:.2f} MB (inner {wire['inner_bytes']/1e6:.2f} MB)"


def test_train_cli_c2dfb():
    res = _run(["-m", "repro_torch.launch.train", "--arch", "qwen2-7b", "--smoke", "--algo", "c2dfb", "--steps", "2",
                "--batch", "2", "--seq", "64", "--nodes", "3", "--inner-k", "3", "--lr", "0.02", "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "val-loss" in res.stdout
    assert "wire bytes/round" in res.stdout
    assert _reference_wire_line("qwen2-7b", 3, 3, 0.02) in res.stdout.splitlines()


def test_serve_cli():
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "gemma2-27b", "--smoke", "--batch", "2",
                "--prompt-len", "32", "--gen", "4", "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "decoded" in res.stdout and "tok/s on cpu" in res.stdout


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_clis_refuse_cuda_without_a_card(cli):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    args = ["--arch", "phi3-mini-3.8b", "--smoke"] + (["--steps", "1"] if cli == "train" else ["--gen", "2"])
    res = _run(["-m", f"repro_torch.launch.{cli}"] + args)  # --device defaults to cuda
    assert res.returncode != 0
    assert 'no CUDA device is available; pass device="cpu"' in res.stderr


def test_c2dfb_cli_streams_telemetry_and_checkpoints(tmp_path):
    """In process, at a tiny size: --obs writes the round and node records
    (bf16 node distances included) and --ckpt-dir the merged model."""
    import json

    from repro_torch.checkpoint import latest_checkpoint
    from repro_torch.launch import train

    obs, ckpt = tmp_path / "run.jsonl", tmp_path / "ckpt"
    train.main(["--arch", "qwen2-7b", "--smoke", "--algo", "c2dfb_nc", "--steps", "1", "--batch", "2", "--seq", "32",
                "--nodes", "3", "--inner-k", "1", "--device", "cpu", "--obs", str(obs), "--ckpt-dir", str(ckpt)])
    kinds = [json.loads(line)["kind"] for line in obs.read_text().splitlines()]
    assert kinds.count("round") == 1 and kinds.count("node") == 3
    assert latest_checkpoint(str(ckpt)).endswith("ckpt_00000001.msgpack.zst")
