"""The port's binary, `python -m karpenter_tpu_torch`, on the CPU.

(a) `--demo 20 --run-seconds 4 --device cpu` in a subprocess: while it
    runs, `/healthz`, `/readyz` and `/metrics` answer over HTTP on the
    port it logs; it exits 0 and logs its nodes and the 20 bound pods.
(b) Without a card and without `--device cpu` it exits non-zero with
    the error, before anything runs: there is no fallback to the CPU.
(c) `--state-file`: a run saves the port's own store on shutdown and a
    second run loads it (the provider rehydrated from the claims), its
    pods still bound; the store is the port's `KubeClient.save` format,
    loaded by `KubeClient.load`.
(d) The flags are the JAX binary's (`karpenter_tpu/__main__.py`) and
    `--device`.
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT), **extra)


def _run(args, timeout=180, **extra):
    return subprocess.run([sys.executable, "-m", "karpenter_tpu_torch", *args], cwd=ROOT,
                          env=_env(**extra), capture_output=True, text=True,
                          timeout=timeout)


COMMON = ["--metrics-port", "0", "--metrics-bind-host", "127.0.0.1", "--tick-seconds", "0.5"]


def test_demo_serves_probes_and_binds():
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "--demo", "20", "--run-seconds", "4",
         "--device", "cpu", *COMMON], cwd=ROOT, env=_env(), stderr=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"operator up: .* metrics=127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines)
        base = f"http://127.0.0.1:{port}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
        ready = json.loads(urllib.request.urlopen(f"{base}/readyz", timeout=10).read())
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        _, rest = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = "".join(lines) + rest
    assert proc.returncode == 0, log
    assert health["ok"] and "checks" in ready
    assert "karpenter_operator_tick_duration_seconds" in metrics
    assert "device=cpu" in log
    m = re.search(r"shutdown: (\d+) nodes, (\d+) bound pods", log)
    assert m and int(m.group(1)) >= 1 and int(m.group(2)) == 20, log


def test_no_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    out = _run(["--demo", "5", "--run-seconds", "1", *COMMON], CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "operator up" not in out.stderr


def test_state_file_round_trip(tmp_path):
    path = str(tmp_path / "store.ckpt")
    first = _run(["--demo", "6", "--run-seconds", "3", "--device", "cpu",
                  "--state-file", path, *COMMON])
    assert first.returncode == 0, first.stderr
    assert "state saved to" in first.stderr and os.path.exists(path)
    from karpenter_tpu_torch.kube.client import KubeClient

    kube = KubeClient.load(path)
    assert sum(1 for p in kube.pods() if p.spec.node_name) == 6 and kube.node_claims()
    second = _run(["--run-seconds", "2", "--device", "cpu", "--state-file", path, *COMMON])
    assert second.returncode == 0, second.stderr
    assert "state loaded from" in second.stderr
    assert re.search(r"rehydrated \d+ instances", second.stderr)
    m = re.search(r"shutdown: (\d+) nodes, (\d+) bound pods", second.stderr)
    assert m and int(m.group(2)) == 6, second.stderr


def test_flags_are_the_jax_binarys_and_device():
    from karpenter_tpu.__main__ import build_parser as jparser
    from karpenter_tpu_torch.__main__ import build_parser

    def flags(p):
        return sorted(a.option_strings[0] for a in p._actions if a.option_strings)

    ours, theirs = flags(build_parser()), flags(jparser())
    assert sorted(set(ours) - set(theirs)) == ["--device"]
    assert set(theirs) <= set(ours)
    assert build_parser().parse_args([]).device == "cuda"
