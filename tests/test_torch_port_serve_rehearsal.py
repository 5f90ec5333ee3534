"""Torch port, the serving rehearsal (``tools/serve_rehearsal.py``) on the
CPU: the index the rehearsal builds against JAX's ``RetrievalIndex`` on the
same rows (2,048 of the flagship's 1,536 columns), the timed index run, and
the micro-batcher's coalesced answers against one-at-a-time ones with its
counts; then every new tool imported where JAX cannot be."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.serve import RetrievalIndex as JIndex
from transformer_clip_eeg_tpu_torch.serve import RetrievalIndex
from transformer_clip_eeg_tpu_torch.tools import serve_rehearsal as sv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, DIM = 2048, 1536
SCORE_TOL = 1e-6
TOOLS = ("learning_quality", "scale_rehearsal", "wav2vec_rehearsal", "serve_rehearsal")


def test_index_topk_equals_jax_on_the_rehearsal_rows():
    mine = RetrievalIndex(DIM, capacity=ROWS + 64, device="cpu")
    theirs = JIndex(DIM, capacity=ROWS + 64)
    for chunk in sv.candidate_chunks(ROWS, DIM):
        mine.add(chunk)
        theirs.add(chunk)
    queries = sv.unit_rows(np.random.default_rng(5), 16, DIM)
    for q in (queries[:1], queries):
        s, i = mine.topk(q, k=10)
        js, ji = theirs.topk(q, k=10)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=SCORE_TOL)


def test_index_bench_records_every_latency():
    rec = sv.bench_index(ROWS, 64, device="cpu", reps=5)
    assert rec["rows"] == ROWS and rec["bulk_build_s"] > 0
    for key in ("add", "topk_q1", "topk_q16"):
        assert 0 < rec[f"{key}_p50_ms"] <= rec[f"{key}_p99_ms"]
    assert "memory_allocated_gb" not in rec  # a card's number only


def test_microbatcher_coalesces_to_the_same_answers():
    clients, requests = 3, 2
    off, on = sv.bench_microbatch(clients=clients, requests=requests, windows=2,
                                  speech_dim=16, depth=2, chunk=8, device="cpu")
    assert off["batch_window_ms"] == 0.0 and "dispatches" not in off
    assert on["requests"] == off["requests"] == clients * requests
    assert on["dispatches"] <= on["batcher_requests"] == clients * requests
    assert on["coalesced_vs_alone"] <= sv.COALESCE_TOL
    assert on["p50_ms"] <= on["p99_ms"]


def test_rehearsal_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sv.main(["--rows", "16"])


def test_tools_import_without_jax():
    """Each new tool imports in a process where ``jax`` and the JAX package
    cannot be imported, and loads nothing of either."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['transformer_clip_eeg_tpu'] = None\n"
        + "".join(f"import transformer_clip_eeg_tpu_torch.tools.{t}\n" for t in TOOLS)
        + "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'transformer_clip_eeg_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
