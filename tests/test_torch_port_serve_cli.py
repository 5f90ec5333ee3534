"""Torch port, the serving command lines on the CPU: ``serve.main`` (embed
only and retrieval, JAX's flags, outputs and errors) and ``server.main`` in
a subprocess, both on a run the port's CLI trained, against an
``InferenceSession`` of that run."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu_torch import cli, serve
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.serve import InferenceSession, RetrievalIndex

REPO = Path(__file__).resolve().parent.parent
SP_D, T = 16, 192
TOL = 1e-6  # the CLI and the session run the same weights on the same device
WAIT_S = 60


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run directory trained by the port's CLI, and its windows."""
    root = str(tmp_path_factory.mktemp("sparrkulee_serve"))
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    out = tmp_path_factory.mktemp("serve_runs")
    torch.set_num_threads(2)
    assert cli.main(["--data_dir", root, "--run", "0", "--epochs", "1", "--skip_eval", "yes",
                     "--batch_size", "4", "--attention_depth", "1", "--latent_dim", "4",
                     "--speech_dim_override", str(SP_D), "--results_folder", str(out)],
                    device="cpu") == 0
    (name,) = os.listdir(out)
    rng = np.random.default_rng(0)
    files = {"eeg": rng.standard_normal((7, T, 64)).astype(np.float32),
             "speech": rng.standard_normal((5, T, SP_D)).astype(np.float32),
             "cand": rng.standard_normal((9, T, SP_D)).astype(np.float32)}
    paths = {}
    for k, v in files.items():
        paths[k] = str(out / f"{k}.npy")
        np.save(paths[k], v)
    session = InferenceSession.from_results_dir(str(out / name), chunk=4, device="cpu")
    return {"dir": str(out / name), "paths": paths, "arrays": files, "session": session,
            "tmp": out}


def _serve(run, *argv):
    return serve.main(["--results_folder", run["dir"], "--chunk", "4", *argv], device="cpu")


@pytest.mark.parametrize("what", ["eeg", "eeg_mvn", "speech"])
def test_embed_only_equals_the_session(run, what):
    out = str(run["tmp"] / f"emb_{what}.npy")
    flags = ["--speech", run["paths"]["speech"]] if what == "speech" else \
        ["--eeg", run["paths"]["eeg"]] + (["--mvn"] if what == "eeg_mvn" else [])
    assert _serve(run, *flags, "--out", out, "--compile_cache_dir", "auto") == 0
    got = np.load(out)
    sess = run["session"]
    want = sess.embed_speech(run["arrays"]["speech"]) if what == "speech" else \
        sess.embed_eeg(run["arrays"]["eeg"], normalize=what == "eeg_mvn")
    assert got.shape == want.shape and len(got) == len(run["arrays"][what.split("_")[0]])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_retrieval_writes_jaxs_json(run):
    out = str(run["tmp"] / "retrieval.json")
    assert _serve(run, "--eeg", run["paths"]["eeg"], "--candidates", run["paths"]["cand"],
                  "--topk", "3", "--out", out) == 0
    got = json.load(open(out))
    assert set(got) == {"indices", "scores"}
    sess = run["session"]
    index = RetrievalIndex.from_embeddings(sess.embed_speech(run["arrays"]["cand"]),
                                           device="cpu")
    scores, ids = index.topk(sess.embed_eeg(run["arrays"]["eeg"]), 3)
    assert got["indices"] == ids.tolist()
    np.testing.assert_allclose(np.asarray(got["scores"]), scores, atol=TOL, rtol=0)
    assert np.asarray(got["scores"]).shape == (7, 3)


@pytest.mark.parametrize("flags", [
    ["--eeg", "e.npy", "--topk", "3"],
    ["--candidates", "c.npy", "--topk", "3"],
    ["--eeg", "e.npy", "--candidates", "c.npy"],
    ["--eeg", "e.npy", "--speech", "s.npy"],
    [],
], ids=["no_candidates", "no_eeg", "no_topk", "eeg_and_speech", "neither"])
def test_misuse_exits_with_code_2(run, flags, capsys):
    with pytest.raises(SystemExit) as exc:
        _serve(run, *flags, "--out", str(run["tmp"] / "x.npy"))
    assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        serve.main(["--eeg", "e.npy"], device="cpu")  # --results_folder/--out required
    assert exc.value.code == 2


def test_shard_raises_not_ported(run):
    """``--shard N`` is ported (``tests/test_torch_port_serve_shard.py``):
    a chunk that does not divide over the N ranks raises JAX's
    ``ValueError`` before any rank starts, and a negative count exits 2."""
    with pytest.raises(ValueError, match=r"chunk 4 must divide by the data axis \(3\)"):
        _serve(run, "--eeg", run["paths"]["eeg"], "--shard", "3", "--out", "x.npy")
    with pytest.raises(SystemExit) as exc:
        _serve(run, "--eeg", run["paths"]["eeg"], "--shard", "-1", "--out", "x.npy")
    assert exc.value.code == 2


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def test_server_cli_serves_the_run_and_stops_on_sigint(run):
    """``python -m ...server`` equivalent on the CPU: it prints its URL
    (``--port 0``), answers /healthz, an embed and a top-k as the session
    does, and exits 0 on SIGINT."""
    code = ("import sys; from transformer_clip_eeg_tpu_torch.server import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--results_folder", run["dir"], "--port", "0",
         "--chunk", "4", "--candidates", run["paths"]["cand"]],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=WAIT_S)
            if line.startswith("serving "):
                url = line.rsplit(" on ", 1)[1].strip()
        assert url.startswith("http://127.0.0.1:") and not url.endswith(":0")
        health = _get(f"{url}/healthz")
        cfg = run["session"].cfg
        assert health == {"status": "ok", "model_arch": cfg.model_arch,
                          "eeg_encoder": cfg.eeg_encoder,
                          "speech_encoder": cfg.speech_encoder,
                          "window_length": cfg.window_length,
                          "index_size": 9, "index_capacity": 1024}
        eeg = run["arrays"]["eeg"][:3]
        got = np.asarray(_post(f"{url}/v1/embed/eeg", {"windows": eeg.tolist()})["embeddings"])
        want = run["session"].embed_eeg(eeg)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        top = _post(f"{url}/v1/retrieval/topk", {"queries": want.tolist(), "k": 2})
        index = RetrievalIndex.from_embeddings(
            run["session"].embed_speech(run["arrays"]["cand"]), device="cpu")
        scores, ids = index.topk(want, 2)
        assert top["ids"] == ids.tolist()
        np.testing.assert_allclose(np.asarray(top["scores"]), scores, atol=TOL, rtol=0)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("module", ["serve", "server"])
def test_module_runs_as_a_program(module):
    """``python -m transformer_clip_eeg_tpu_torch.<module> --help`` reaches
    ``main`` and prints JAX's flags."""
    out = subprocess.run([sys.executable, "-m", f"transformer_clip_eeg_tpu_torch.{module}",
                          "--help"], cwd=str(REPO), capture_output=True, text=True,
                         timeout=WAIT_S, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert "--results_folder" in out.stdout and "--compile_cache_dir" in out.stdout
