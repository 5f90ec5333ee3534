"""SparrKULee-scale rehearsal of the port: a synthetic corpus at the real
corpus's shape through every path whose cost grows with it.

Counterpart of the JAX package's ``scripts/scale_rehearsal.py``, with its
stages, flags and records.  The corpus: 15 stories x 600 s at 64 Hz, 85
training and 14 held-out subjects, each recording 10 of the stories,
1024-dim wav2vec features (``SHAPE``; ``--n_subjects`` etc. override it).

  gen     write the corpus (``data/fixtures.make_fixture``; a marker makes it
          idempotent), and with ``--mm_subjects`` / ``--mm_noise`` a held-out
          match-mismatch set that does not saturate
          (``regen_icassp_testset``); ``--env_decodable`` the positive-control
          corpus whose envelope is linear in the EEG
  ingest  host seconds and peak RSS of the eager ingest
          (``data/dataset.EEGWindowDataset``): fold 0's training split, then
          the union of folds 0-8 that fold-parallel CV holds
  train   ``cli.main`` on ``--device``: per epoch the ``loss.txt`` lines and
          the chunk store's phases (uploads, GB, seconds, wait), the
          evaluation suite's seconds and results unless ``--skip_eval``, the
          process's kernel launches
  cv      ``cv.main --parallel yes`` over ``--folds``: the same lines, the
          summary and each fold's evaluation results
  evict   ``train/device_data.DeviceChunkStore`` with an ample byte budget,
          then one of about 2.5 chunks: two epochs walked from the same
          seeds, the full bytes of every gathered batch digested (SHA-1);
          the digests must be equal, and the uploads and GB (the store's
          own counts, kept by ``_insert``) and walk seconds of each leg are
          the cost of the thrash

Each stage runs in a process of its own, so the peak RSS is the stage's.
Records are printed and appended to ``<out>/scale_results.jsonl``.

    python -m transformer_clip_eeg_tpu_torch.tools.scale_rehearsal --root <dir>
    SCALE_SMOKE=1 python -m ... --root <dir> --device cpu --batch_size 16

``SCALE_SMOKE=1``: 4 stories x 90 s, 5 + 2 subjects, 32-dim features, and a
depth-2 model (the CLI cuts a 90 s story into 29 windows: ``--batch_size``
<= 29).  Runs
on the card unless ``--device cpu``; with no card ``--device cuda``
raises.  Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.tools import kernel_launches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMOKE = os.environ.get("SCALE_SMOKE", "") == "1"
if SMOKE:
    SHAPE = dict(n_stories=4, n_subjects=5, n_test_subjects=2,
                 story_seconds=90, speech_dim=32, stories_per_subject=3)
else:
    SHAPE = dict(n_stories=15, n_subjects=85, n_test_subjects=14,
                 story_seconds=600, speech_dim=1024, stories_per_subject=10)
# the smoke shrinks the model too, as the JAX rehearsal's does
MODEL_FLAGS = (["--attention_depth", "2", "--lstm_units", "16", "--latent_dim", "4"]
               if SMOKE else [])
WINDOW = 192
EVICT_SUBJECTS = 8   # the evict stage ingests at most this many subjects
EVICT_BATCH = 32     # and batches of at most this many windows
EVICT_TINY_CHUNKS = 2.5


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _emit(out_dir: str, record: dict) -> None:
    record["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")
    line = json.dumps(record)
    print(line, flush=True)
    with open(os.path.join(out_dir, "scale_results.jsonl"), "a") as f:
        f.write(line + "\n")


def _regen_mm(args, speech_dim: int) -> None:
    from transformer_clip_eeg_tpu_torch.data.fixtures import regen_icassp_testset

    # --mm_noise is compared against None: 0 asks for a noiseless control set
    regen_icassp_testset(args.root, speech_dim=speech_dim, n_subjects=args.mm_subjects or 14,
                         noise=12.0 if args.mm_noise is None else args.mm_noise,
                         trials=args.mm_trials, env_decodable=args.env_decodable,
                         env_gain=args.env_gain)


def _wants_mm(args) -> bool:
    return bool(args.mm_subjects) or args.mm_noise is not None


def stage_gen(args) -> dict:
    from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture

    marker = os.path.join(args.root, ".scale_generated.json")
    if os.path.exists(marker):
        # the corpus is kept; a requested match-mismatch set is made anew
        if _wants_mm(args):
            _regen_mm(args, SHAPE["speech_dim"])
        with open(marker) as f:
            return {"stage": "gen", "skipped": True, **json.load(f)}
    t0 = time.time()
    shape = dict(SHAPE)
    if args.env_decodable:
        shape.update(env_decodable=True, env_gain=args.env_gain)
    make_fixture(args.root, **shape)
    if _wants_mm(args):
        _regen_mm(args, shape["speech_dim"])
    gen_s = time.time() - t0
    disk = sum(os.path.getsize(p) for p in glob.glob(os.path.join(args.root, "**", "*"),
                                                     recursive=True) if os.path.isfile(p))
    info = {"gen_s": gen_s, "disk_gb": disk / 2**30, **SHAPE,
            "env_decodable": bool(args.env_decodable)}
    with open(marker, "w") as f:
        json.dump(info, f)
    return {"stage": "gen", **info}


def discover(root: str, run: int, n_subs: int):
    from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final

    return get_train_val_test_files_final(root, run, "wav2vec_19",
                                          os.path.join(root, "fold_split.json"), n_subs)


def chunk_gb(ds) -> float:
    """The host bytes of a dataset's chunks: EEG and stimulus features."""
    return sum(c["eeg"].nbytes + sum(c[k].nbytes for k in ds.features_to_load if k in c)
               for c in ds.chunks.values() if "eeg" in c) / 2**30


def stage_ingest(args) -> dict:
    from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset

    files = discover(args.root, 0, SHAPE["n_subjects"])
    out = {"stage": "ingest"}
    t0 = time.time()
    ds = EEGWindowDataset(files[0], files[4], WINDOW, WINDOW, batch_size=args.batch_size)
    out.update(fold0_train_ingest_s=time.time() - t0, fold0_train_rss_gb=_rss_gb(),
               fold0_train_files=len(files[0]), fold0_train_chunks=len(ds.batches_keys),
               fold0_train_segments=ds.get_number_of_stimuli_segments(),
               fold0_train_chunk_gb=chunk_gb(ds))
    del ds
    # fold-parallel CV holds every story of folds 0-8 at once
    t0 = time.time()
    union = EEGWindowDataset(files[0] + files[1], files[4] + files[5], WINDOW, WINDOW,
                             batch_size=args.batch_size)
    out.update(union_ingest_s=time.time() - t0, union_rss_gb=_rss_gb(),
               union_files=len(files[0]) + len(files[1]), union_chunks=len(union.batches_keys),
               union_segments=union.get_number_of_stimuli_segments(),
               union_chunk_gb=chunk_gb(union))
    return out


def read_loss_txt(path: str) -> dict:
    """The epoch lines of a ``loss.txt`` and, per epoch, its phases record."""
    lines, phases = [], []
    if os.path.exists(path):
        with open(path) as f:
            for ln in f:
                if not ln.startswith("epoch "):
                    continue
                if " phases " in ln:
                    phases.append(json.loads(ln.split(" phases ", 1)[1]))
                else:
                    lines.append(ln.strip())
    return {"epoch_lines": lines[:12], "phases": phases[:12]}


# each evaluation JSON's subject mean under its record name; the probes'
# files hold negative Pearson losses, so their r is the negated mean
EVAL_FILES = {"evaluation_challenge_set_2023_mm": ("mm_accuracy", 1.0),
              "evaluation_regression": ("probe_r_sub_specific", -1.0),
              "evaluation_regression_general_model_env": ("probe_r_general", -1.0),
              "evaluation_challenge_set_2023_regression": ("challenge_r_general", 1.0),
              "evaluation_challenge_set_2023_regression_sub_specific":
                  ("challenge_r_sub_specific", 1.0)}


def eval_results(run_dir: str) -> dict:
    """A run directory's evaluation results, averaged over the subjects:
    match-mismatch accuracy and top-1 retrieval, the regression probes'
    Pearson r (per subject and general) and the challenge regression's."""
    out = {}
    path = os.path.join(run_dir, "evaluation_challenge_set_2023_mm_top_x.json")
    if os.path.exists(path):
        with open(path) as f:  # per subject the top-1 ... top-10 shares
            out["mm_top1"] = float(np.mean([v[0] for v in json.load(f).values()]))
    for name, (key, sign) in EVAL_FILES.items():
        path = os.path.join(run_dir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                values = list(json.load(f).values())
            if values:
                out[key] = sign * float(np.mean(np.asarray(values, np.float64)))
    return out


@contextlib.contextmanager
def timed_suites():
    """The seconds of each evaluation suite ``cli.run_eval_suite`` runs
    while the context is open (a list, filled as they end)."""
    from transformer_clip_eeg_tpu_torch import cli

    real, spans = cli.run_eval_suite, []

    def timed(*args, **kwargs):
        t0 = time.time()
        try:
            return real(*args, **kwargs)
        finally:
            spans.append(time.time() - t0)

    cli.run_eval_suite = timed
    try:
        yield spans
    finally:
        cli.run_eval_suite = real


def _train_flags(args) -> list:
    return ["--data_dir", args.root, "--epochs", str(args.epochs),
            "--number_of_training_subjects", str(args.train_subjects),
            "--batch_size", str(args.batch_size), "--patience", str(args.patience),
            "--skip_eval", "yes" if args.skip_eval else "no",
            "--chunk_store_dtype", args.chunk_store_dtype,
            "--speech_dim_override", str(SHAPE["speech_dim"])] + MODEL_FLAGS


def stage_train(args) -> dict:
    from transformer_clip_eeg_tpu_torch import cli

    results = os.path.join(args.out, "train_run")
    before = set(glob.glob(os.path.join(results, "*")))
    t0 = time.time()
    with timed_suites() as suites:
        rc = cli.main(["--results_folder", results, "--run", "0"] + _train_flags(args),
                      device=args.device)
    out = {"stage": "train", "rc": rc, "total_s": time.time() - t0, "suite_s": suites,
           "rss_gb": _rss_gb(),
           "train_subjects": args.train_subjects, "epochs": args.epochs,
           "batch_size": args.batch_size, "chunk_store_dtype": args.chunk_store_dtype,
           "eval": not args.skip_eval, "kernel_launches": kernel_launches()}
    new = sorted(set(glob.glob(os.path.join(results, "*"))) - before)
    if new:
        out.update(read_loss_txt(os.path.join(new[-1], "loss.txt")))
        out["eval_results"] = eval_results(new[-1])
    return out


def stage_cv(args) -> dict:
    from transformer_clip_eeg_tpu_torch import cv

    results = os.path.join(args.out, "cv_run")
    t0 = time.time()
    with timed_suites() as suites:
        rc = cv.main(["--folds", *[str(f) for f in args.folds], "--parallel", "yes",
                      "--results_folder", results] + _train_flags(args), device=args.device)
    out = {"stage": "cv", "rc": rc, "total_s": time.time() - t0, "suite_s": suites,
           "rss_gb": _rss_gb(),
           "folds": args.folds, "chunk_store_dtype": args.chunk_store_dtype,
           "eval": not args.skip_eval, "env_decodable": bool(args.env_decodable),
           "kernel_launches": kernel_launches(),
           **read_loss_txt(os.path.join(results, "loss.txt"))}
    summary = os.path.join(results, "cv_summary.json")
    if os.path.exists(summary):
        with open(summary) as f:
            folds = json.load(f)["folds"]
        out["fold_results"] = {fold: eval_results(s["results_dir"]) for fold, s in folds.items()}
    return out


def evict_dataset(root: str, batch_size: int, n_subjects: int):
    """The evict stage's dataset: fold 0's training split of at most
    ``EVICT_SUBJECTS`` subjects, batches of at most ``EVICT_BATCH``."""
    from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset

    files = discover(root, 0, min(EVICT_SUBJECTS, n_subjects))
    return EEGWindowDataset(files[0], files[4], WINDOW, WINDOW,
                            batch_size=min(batch_size, EVICT_BATCH), seed=0)


def walk_batches(store, device, epochs: int = 2):
    """Every batch of ``epochs`` shuffled walks, gathered on the store's
    device and brought to the host as numpy ``(eeg, speech, ids)``: the
    dataset's index stream reset to seed 7, the chunk order of each epoch
    drawn from seed 123, so two stores walk the same batches."""
    from transformer_clip_eeg_tpu_torch.train.device_data import gather_batch

    store.dataset.rng = np.random.default_rng(7)
    for _ in range(epochs):
        rng = np.random.default_rng(123)
        for eeg_d, sp_d, ids_d, idx, subs, _p in store.epoch_batches(rng=rng, shuffle=True):
            batch = gather_batch(eeg_d, sp_d, ids_d, torch.from_numpy(idx).to(device),
                                 torch.from_numpy(subs).to(device))
            yield tuple(batch[k].cpu().numpy() for k in ("eeg", "speech", "ids"))


def digest(batch) -> str:
    """SHA-1 of the full bytes of a batch's arrays (a sum could pass with
    rows permuted or misplaced)."""
    h = hashlib.sha1()
    for a in batch:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def stage_evict(args) -> dict:
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device
    from transformer_clip_eeg_tpu_torch.train import device_data as dd

    device = resolve_device(args.device)
    ds = evict_dataset(args.root, args.batch_size, SHAPE["n_subjects"])
    sizes = [ds.chunks[k]["eeg"].nbytes + ds.chunks[k][ds.features_to_load[0]].nbytes
             for k in ds.batches_keys]
    tiny = int(EVICT_TINY_CHUNKS * max(sizes))
    # a warm-up walk: on the card the caching allocator and the streams are
    # warm before the first timed leg
    warm = dd.DeviceChunkStore(ds, device=device, max_resident=2)
    for i, _ in zip(range(3), walk_batches(warm, device, epochs=1)):
        pass
    warm.release()
    del warm
    legs = {}
    for label, budget in (("ample", 1 << 50), ("tiny", tiny)):
        store = dd.DeviceChunkStore(ds, device=device, max_resident=2)
        store.budget_bytes, store.max_resident = budget, None
        t0 = time.time()
        sums = [digest(b) for b in walk_batches(store, device)]
        walk_s = time.time() - t0
        stats = store.snapshot_stats()
        legs[label] = {"sums": sums, "uploads": stats["uploads"],
                       "upload_gb": stats["upload_bytes"] / 2**30, "walk_s": walk_s,
                       "budget_gb": budget / 2**30, "batches": len(sums)}
        store.release()
    if legs["ample"]["sums"] != legs["tiny"]["sums"]:
        raise AssertionError("eviction changed the gathered batches")
    strip = lambda leg: {k: v for k, v in leg.items() if k != "sums"}  # noqa: E731
    return {"stage": "evict", "correct": True, "ample": strip(legs["ample"]),
            "tiny": strip(legs["tiny"]), "n_chunks": len(ds.batches_keys),
            "thrash_uploads": legs["tiny"]["uploads"] - legs["ample"]["uploads"],
            "thrash_s": legs["tiny"]["walk_s"] - legs["ample"]["walk_s"]}


STAGES = {"gen": stage_gen, "ingest": stage_ingest, "train": stage_train, "cv": stage_cv,
          "evict": stage_evict}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="corpus root (written if absent)")
    ap.add_argument("--out", default="", help="results dir (default <root>/_scale_out)")
    ap.add_argument("--stage", default="", help="run ONE stage in this process")
    ap.add_argument("--stages", nargs="+", default=["gen", "ingest", "train", "cv", "evict"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--train_subjects", type=int, default=0,
                    help="0 = the corpus's n_subjects")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--patience", type=int, default=50)
    ap.add_argument("--chunk_store_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--env_decodable", action="store_true",
                    help="the positive-control corpus: the envelope linear in the EEG")
    ap.add_argument("--env_gain", type=float, default=4.0,
                    help="per-channel strength of the envelope direction in the EEG mix")
    ap.add_argument("--mm_subjects", type=int, default=0,
                    help="regenerate the held-out match-mismatch set with this many "
                         "subjects (0 = keep the corpus's)")
    ap.add_argument("--mm_noise", type=float, default=None,
                    help="EEG noise std of the regenerated set (12 does not saturate; 0 "
                         "is noiseless; omitted: no regeneration unless --mm_subjects)")
    ap.add_argument("--mm_trials", type=int, default=64)
    ap.add_argument("--folds", type=int, nargs="+", default=[0, 1], help="the cv stage's folds")
    for key, default in SHAPE.items():
        ap.add_argument(f"--{key}", type=int, default=default)
    return ap


def stage_command(args, stage: str) -> list:
    cmd = [sys.executable, "-m", "transformer_clip_eeg_tpu_torch.tools.scale_rehearsal",
           "--root", args.root, "--out", args.out, "--stage", stage, "--device", args.device,
           "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
           "--train_subjects", str(args.train_subjects), "--patience", str(args.patience),
           "--chunk_store_dtype", args.chunk_store_dtype,
           "--folds", *[str(f) for f in args.folds]]
    for key in SHAPE:
        cmd += [f"--{key}", str(SHAPE[key])]
    if args.skip_eval:
        cmd.append("--skip_eval")
    if args.env_decodable:
        cmd += ["--env_decodable", "--env_gain", str(args.env_gain)]
    if _wants_mm(args):
        cmd += ["--mm_subjects", str(args.mm_subjects), "--mm_trials", str(args.mm_trials)]
        if args.mm_noise is not None:
            cmd += ["--mm_noise", str(args.mm_noise)]
    return cmd


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device

    resolve_device(args.device)  # no card: raise before anything is written
    for key in SHAPE:
        SHAPE[key] = getattr(args, key)
    args.train_subjects = args.train_subjects or SHAPE["n_subjects"]
    args.out = args.out or os.path.join(args.root, "_scale_out")
    os.makedirs(args.out, exist_ok=True)
    if args.stage:
        rec = STAGES[args.stage](args)
        _emit(args.out, rec)
        return rec.get("rc", 0)  # a failed training run fails its stage
    for stage in args.stages:
        print(f"=== stage {stage} ===", flush=True)
        rc = subprocess.run(stage_command(args, stage), cwd=REPO).returncode
        if rc != 0:
            print(f"stage {stage} FAILED rc={rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
