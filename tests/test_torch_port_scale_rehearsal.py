"""Torch port, the scale rehearsal (``tools/scale_rehearsal.py``) on the CPU
at ``SCALE_SMOKE``: all five stages through the tool's ``main``, each in a
process of its own; the ingest's chunk and segment counts against JAX's
``EEGWindowDataset`` on the same corpus; eviction under the tiny budget
(equal digests, more uploads than the ample leg); and the first epoch's
gathered batches against JAX's ``DeviceChunkStore``, byte for byte."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.data.dataset import EEGWindowDataset as JDataset
from transformer_clip_eeg_tpu.train.device_data import DeviceChunkStore as JStore
from transformer_clip_eeg_tpu.train.device_data import gather_batch as j_gather
from transformer_clip_eeg_tpu_torch.tools import scale_rehearsal as sr
from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's smoke shape with 5 stories (a shape override): fold 0's training
# split then holds 3 chunks, more than the tiny budget's 2.5
N_STORIES, N_SUBJECTS, BATCH = 5, 5, 16


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scale_smoke"))
    env = dict(os.environ, SCALE_SMOKE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_clip_eeg_tpu_torch.tools.scale_rehearsal",
         "--root", root, "--device", "cpu", "--n_stories", str(N_STORIES),
         "--batch_size", str(BATCH), "--epochs", "1", "--skip_eval", "--train_subjects", "2",
         "--folds", "0", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(root, "_scale_out", "scale_results.jsonl")) as f:
        records = {r["stage"]: r for r in map(json.loads, f)}
    return root, records


def test_five_stages_run_and_record(rehearsal):
    _, rec = rehearsal
    assert list(rec) == ["gen", "ingest", "train", "cv", "evict"]
    assert rec["gen"]["n_stories"] == N_STORIES and rec["gen"]["speech_dim"] == 32
    for stage in ("train", "cv"):
        assert rec[stage]["rc"] == 0 and rec[stage]["rss_gb"] > 0
        assert len(rec[stage]["epoch_lines"]) == 1 and len(rec[stage]["phases"]) == 1
    assert rec["train"]["suite_s"] == rec["cv"]["suite_s"] == []  # --skip_eval
    # fold-parallel CV's store: the union's chunks uploaded once
    assert rec["cv"]["phases"][0]["uploads"] == rec["ingest"]["union_chunks"]
    assert rec["cv"]["folds"] == [0, 1]


def test_ingest_counts_equal_jax_datasets(rehearsal):
    root, rec = rehearsal
    files = sr.discover(root, 0, N_SUBJECTS)
    fold0 = JDataset(files[0], files[4], 192, 192, batch_size=BATCH)
    union = JDataset(files[0] + files[1], files[4] + files[5], 192, 192, batch_size=BATCH)
    ing = rec["ingest"]
    assert ing["fold0_train_chunks"] == len(fold0.batches_keys) == 3
    assert ing["fold0_train_segments"] == fold0.get_number_of_stimuli_segments()
    assert ing["union_chunks"] == len(union.batches_keys)
    assert ing["union_segments"] == union.get_number_of_stimuli_segments()
    assert ing["union_chunk_gb"] > ing["fold0_train_chunk_gb"] > 0


def test_eviction_keeps_the_batches_and_pays_uploads(rehearsal):
    _, rec = rehearsal
    ev = rec["evict"]
    assert ev["correct"] and ev["n_chunks"] == 3
    assert ev["ample"]["uploads"] == ev["n_chunks"]  # each chunk once, then resident
    assert ev["tiny"]["uploads"] > ev["ample"]["uploads"]
    assert ev["thrash_uploads"] == ev["tiny"]["uploads"] - ev["ample"]["uploads"]
    assert ev["tiny"]["batches"] == ev["ample"]["batches"] > 0


def test_first_epoch_batches_equal_jax_store(rehearsal):
    """The evict stage's walk (dataset stream reset to seed 7, chunk order
    from seed 123) gathers JAX's store's batches: EEG and speech byte for
    byte, the ids as values (int64 against JAX's int32)."""
    root, _ = rehearsal
    ds = sr.evict_dataset(root, BATCH, N_SUBJECTS)
    mine = list(sr.walk_batches(DeviceChunkStore(ds, device="cpu", prefetch=False),
                                torch.device("cpu"), epochs=1))
    files = sr.discover(root, 0, min(sr.EVICT_SUBJECTS, N_SUBJECTS))
    jds = JDataset(files[0], files[4], 192, 192, batch_size=min(BATCH, sr.EVICT_BATCH), seed=0)
    jds.rng = np.random.default_rng(7)
    store = JStore(jds, prefetch=False)
    theirs = [j_gather(e, s, i, idx.astype(np.int32), subs.astype(np.int32))
              for e, s, i, idx, subs, _p in store.epoch_batches(
                  rng=np.random.default_rng(123), shuffle=True)]
    assert len(mine) == len(theirs) > 0
    for (eeg, speech, ids), want in zip(mine, theirs):
        assert eeg.tobytes() == np.asarray(want["eeg"], np.float32).tobytes()
        assert speech.tobytes() == np.asarray(want["speech"], np.float32).tobytes()
        np.testing.assert_array_equal(ids, np.asarray(want["ids"]))


def test_eval_results_name_each_file_and_turn_probe_losses_into_r(tmp_path):
    files = {"evaluation_challenge_set_2023_mm": {"a": 0.5, "b": 1.0},
             "evaluation_challenge_set_2023_mm_top_x": {"a": [0.25, 1.0], "b": [0.75, 1.0]},
             "evaluation_regression": {"a": -0.25, "b": -0.75},
             "evaluation_regression_general_model_env": {"a": -0.5},
             "evaluation_challenge_set_2023_regression": {"a": 0.125}}
    for name, obj in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(obj))
    assert sr.eval_results(str(tmp_path)) == {
        "mm_top1": 0.5, "mm_accuracy": 0.75, "probe_r_sub_specific": 0.5,
        "probe_r_general": 0.5, "challenge_r_general": 0.125}


def test_timed_suites_times_each_suite_and_restores_the_cli(monkeypatch):
    from transformer_clip_eeg_tpu_torch import cli

    monkeypatch.setattr(cli, "run_eval_suite", lambda *a, **k: "ran")
    with sr.timed_suites() as spans:
        assert cli.run_eval_suite(1, x=2) == "ran" and cli.run_eval_suite() == "ran"
    assert len(spans) == 2 and all(s >= 0 for s in spans)
    assert cli.run_eval_suite() == "ran"


def test_rehearsal_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sr.main(["--root", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
