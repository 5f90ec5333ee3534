"""wav2vec2 extraction rehearsal of the port: a corpus of synthetic stories
through the extraction CLI at XLSR-53's width, stopped mid-run and resumed.

Counterpart of the JAX package's ``scripts/wav2vec_rehearsal.py``.  Writes
``--stories`` stories of ``--story_min`` minutes of 48 kHz audio in the
reference's ``stimuli/eeg/*.npz.gz`` layout (default 50 x 15 min), and a
checkpoint directory of XLSR-53's architecture with random weights
(``config.json`` and ``pytorch_model.bin`` or ``model.safetensors``, written
without ``transformers``).  Then runs ``preprocess.wav2vec``'s CLI in a
process of its own (tap layer 19):

  * the first pass is killed after ``--kill_after`` seconds, or ends itself
    right after its ``--stop_after`` -th story's file is written (a crash at
    a known point); the second pass must skip the stories that have their
    file and extract exactly the others;
  * audio seconds per second of the whole corpus, start-up included;
  * one story extracted again in bfloat16 against the float32 features
    (mean |delta| / mean |f32| < 0.05, JAX's limit).

    python -m transformer_clip_eeg_tpu_torch.tools.wav2vec_rehearsal --root <dir>
    W2V_STORIES=10 python -m ...          (fewer stories, full length)
    W2V_SMOKE=1 python -m ... --root <dir> --device cpu

``W2V_SMOKE=1``: 3 stories of 6 s and a 2-layer model of width 32 (tap
layer 1).  Records are printed and appended to ``<root>/rehearsal.jsonl``.
Runs on the card unless ``--device cpu``; with no card ``--device cuda``
raises.  Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import struct
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from transformer_clip_eeg_tpu_torch.tools import kernel_launches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SR = 48000  # the reference's stimuli are 48 kHz (resampled to 16 kHz on load)
BF16_LIMIT = 0.05  # mean |bf16 - f32| / mean |f32|, JAX tests/test_wav2vec_extraction.py
STOP_CODE = 75  # the exit code of a pass that ended itself at --stop_after

SMOKE_CONFIG = Wav2Vec2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=64, conv_dim=(32, 32), conv_stride=(5, 2),
                              conv_kernel=(10, 3))
SMOKE = os.environ.get("W2V_SMOKE", "") == "1"
if SMOKE:
    N_STORIES, STORY_MIN, CONFIG, LAYERS = 3, 0.1, SMOKE_CONFIG, [1]
else:
    # fewer stories (W2V_STORIES) keep the length, the model and the checks
    N_STORIES = int(os.environ.get("W2V_STORIES", "50"))
    STORY_MIN, CONFIG, LAYERS = 15.0, Wav2Vec2Config(), [19]


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """A ``.safetensors`` file of float32 tensors: the header length (8
    bytes, little-endian), the JSON header padded to 8 bytes, the buffers."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        blob = t.detach().to(torch.float32).contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def build_model_dir(path: str, config: Wav2Vec2Config = CONFIG, seed: int = 0,
                    fmt: str = "bin") -> str:
    """An HF checkpoint directory of ``config``'s architecture with random
    weights from ``seed`` (``Wav2Vec2Model.init_random``), laid out as
    ``Wav2Vec2ForCTC.save_pretrained`` writes it: the ``wav2vec2.`` prefix,
    the positional conv as ``weight_g`` / ``weight_v``, an ``lm_head``;
    ``fmt`` is ``"bin"`` (``pytorch_model.bin``) or ``"safetensors"``.  A
    directory that already holds a ``config.json`` is kept as it is."""
    if os.path.exists(os.path.join(path, "config.json")):
        return path
    if fmt not in ("bin", "safetensors"):
        raise ValueError(f"fmt must be bin or safetensors, got {fmt!r}")
    os.makedirs(path, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    src = Wav2Vec2Model(config)
    src.init_random(gen)
    sd = {f"wav2vec2.{k}": v for k, v in src.state_dict().items()}
    del src
    v = sd.pop("wav2vec2.encoder.pos_conv_embed.conv.weight")
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = v
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = torch.rand(
        1, 1, v.shape[2], generator=gen) + 0.5
    sd["lm_head.weight"] = torch.randn(32, config.hidden_size, generator=gen) * 0.02
    sd["lm_head.bias"] = torch.zeros(32)
    if fmt == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    else:
        write_safetensors(os.path.join(path, "model.safetensors"), sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config.to_hf_dict(), f)
    return path


def story_names(n_stories: int) -> List[str]:
    return [f"rehearsal_story_{i:03d}" for i in range(n_stories)]


def build_stimuli(root: str, n_stories: int = N_STORIES, story_min: float = STORY_MIN,
                  seed: int = 0) -> dict:
    """``n_stories`` stories of noise at 48 kHz, ``stimuli/eeg/<name>.npz.gz``
    holding ``audio`` and ``fs`` (stories already there are kept)."""
    stim_dir = os.path.join(root, "stimuli", "eeg")
    os.makedirs(stim_dir, exist_ok=True)
    n_samples = int(story_min * 60 * SR)
    rng = np.random.default_rng(seed)
    t0, made = time.time(), 0
    for name in story_names(n_stories):
        audio = (rng.standard_normal(n_samples) * 0.1).astype(np.float32)
        out = os.path.join(stim_dir, f"{name}.npz.gz")
        if os.path.exists(out):
            continue
        raw = os.path.join(root, f"{name}.npz")
        np.savez(raw, audio=audio, fs=SR)
        with open(raw, "rb") as f_in, gzip.open(out, "wb", compresslevel=1) as f_out:
            shutil.copyfileobj(f_in, f_out)
        os.remove(raw)
        made += 1
    return {"stories": n_stories, "story_min": story_min, "generated": made,
            "gen_s": time.time() - t0}


def feature_files(root: str, layer: int) -> List[str]:
    return sorted(glob.glob(os.path.join(root, "derivatives", "preprocessed_stimuli",
                                         f"*_-_wav2vec_{layer}.npy")))


def child_main(argv: List[str]) -> int:
    """One extraction pass: ``preprocess.wav2vec.main`` on ``--device``,
    then a line of the process's kernel launches; with ``--stop_after N``
    the process prints that line and ends (exit ``STOP_CODE``) as soon as
    its N-th feature file has been written."""
    from transformer_clip_eeg_tpu_torch.preprocess import wav2vec

    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stop_after", type=int, default=0)
    args, cli_argv = ap.parse_known_args(argv)
    if args.stop_after:
        written = []
        real = wav2vec._replaced_on_close

        def counted(path):
            with real(path) as f:
                yield f
            if "_-_wav2vec_" in os.path.basename(path):
                written.append(path)
                if len(written) == args.stop_after:
                    print(f"kernel launches {json.dumps(kernel_launches())}", flush=True)
                    os._exit(STOP_CODE)

        import contextlib

        wav2vec._replaced_on_close = contextlib.contextmanager(counted)
    rc = wav2vec.main(cli_argv, device=args.device)
    print(f"kernel launches {json.dumps(kernel_launches())}", flush=True)
    return rc


def run_cli(root: str, model_dir: str, dtype: str = "float32", device="cuda",
            layers: Optional[List[int]] = None, timeout_s: Optional[float] = None,
            stop_after: int = 0, label: str = "") -> dict:
    """One pass of the extraction CLI over ``root`` in a new process, its
    output in ``<root>/cli_<label>.log``: killed after ``timeout_s``, or
    ended by itself after ``stop_after`` stories.  Returns its exit code,
    whether it was cut, its wall seconds, the stories it saved and the
    feature files present after it."""
    layers = layers or LAYERS
    cmd = [sys.executable, "-m", "transformer_clip_eeg_tpu_torch.tools.wav2vec_rehearsal",
           "--child", "--device", str(device), "--stop_after", str(stop_after),
           "--dataset_root", root, "--model_path", model_dir,
           "--layers", *[str(x) for x in layers], "--dtype", dtype]
    log_path = os.path.join(root, f"cli_{label or dtype}.log")
    t0 = time.time()
    try:
        with open(log_path, "w") as log_f:
            rc = subprocess.run(cmd, cwd=REPO, timeout=timeout_s, stdout=log_f,
                                stderr=subprocess.STDOUT).returncode
        killed = False
    except subprocess.TimeoutExpired:  # subprocess.run killed it
        rc, killed = None, True
    wall = time.time() - t0
    with open(log_path) as f:
        log = f.read()
    saved = [ln.split("'")[1] for ln in log.splitlines() if ln.startswith("Saved to '")]
    launches = [json.loads(ln.split(" ", 2)[2]) for ln in log.splitlines()
                if ln.startswith("kernel launches ")]
    return {"rc": rc, "killed": killed, "stopped": rc == STOP_CODE, "wall_s": wall,
            "saved": [os.path.basename(p) for p in saved],
            "kernel_launches": launches[-1] if launches else None,
            "files": [os.path.basename(p) for p in feature_files(root, layers[0])],
            "tail": log[-800:] if rc not in (0, STOP_CODE) and not killed else ""}


def bf16_delta(root: str, model_dir: str, device, layer: int) -> dict:
    """The first story extracted again in bfloat16, in ``<root>/bf16_check``,
    against its float32 features."""
    f32_path = feature_files(root, layer)[0]
    story = os.path.basename(f32_path).split("_-_")[0]
    bf_root = os.path.join(root, "bf16_check")
    os.makedirs(os.path.join(bf_root, "stimuli", "eeg"), exist_ok=True)
    shutil.copy(os.path.join(root, "stimuli", "eeg", f"{story}.npz.gz"),
                os.path.join(bf_root, "stimuli", "eeg", f"{story}.npz.gz"))
    run = run_cli(bf_root, model_dir, "bfloat16", device, [layer])
    if run["rc"] != 0:
        raise AssertionError(f"the bf16 pass exited {run['rc']}: {run['tail']}")
    f32 = np.load(f32_path)
    bf16 = np.load(os.path.join(bf_root, "derivatives", "preprocessed_stimuli",
                                os.path.basename(f32_path)))
    delta = float(np.abs(f32 - bf16).mean())
    return {"story": story, "bf16_wall_s": run["wall_s"], "kernel_launches": run["kernel_launches"],
            "mean_abs_delta": delta,
            "rel_to_mean_abs": delta / max(float(np.abs(f32).mean()), 1e-9),
            "limit": BF16_LIMIT}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        return child_main(argv[1:])
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stories", type=int, default=N_STORIES)
    ap.add_argument("--story_min", type=float, default=STORY_MIN)
    ap.add_argument("--kill_after", type=float, default=20 if SMOKE else 180,
                    help="seconds before the first pass is killed (0: not killed)")
    ap.add_argument("--stop_after", type=int, default=0,
                    help="the first pass ends itself after this many stories "
                         "(instead of --kill_after)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: raise before anything is written
    os.makedirs(args.root, exist_ok=True)

    def emit(rec):
        rec["ts"] = time.strftime("%H:%M:%S")
        print(json.dumps(rec), flush=True)
        with open(os.path.join(args.root, "rehearsal.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    emit({"stage": "gen", **build_stimuli(args.root, args.stories, args.story_min)})
    t0 = time.time()
    model_dir = build_model_dir(os.path.join(args.root, "hf_model"))
    emit({"stage": "model_dir", "path": model_dir, "write_s": time.time() - t0,
          "files": sorted(os.listdir(model_dir))})
    total_audio_s = args.stories * args.story_min * 60
    wall = 0.0
    first = None
    if args.stop_after or args.kill_after:
        first = run_cli(args.root, model_dir, "float32", args.device,
                        timeout_s=None if args.stop_after else args.kill_after,
                        stop_after=args.stop_after, label="first")
        emit({"stage": "first_pass_cut", **first})
        if first["rc"] not in (0, STOP_CODE) and not first["killed"]:
            raise AssertionError(f"the first pass exited {first['rc']}: {first['tail']}")
        wall += first["wall_s"]
    names = story_names(args.stories)
    resume = run_cli(args.root, model_dir, "float32", args.device, label="resume")
    wall += resume["wall_s"]
    before = set(first["files"]) if first else set()
    missing = sorted(f"{n}_-_wav2vec_{LAYERS[0]}.npy" for n in names)
    missing = [m for m in missing if m not in before]
    emit({"stage": "resume_to_completion", **resume,
          "extracted_exactly_the_missing": sorted(resume["saved"]) == missing,
          "audio_s": total_audio_s,
          "audio_s_per_s_incl_startup": total_audio_s / max(wall, 1e-9)})
    if resume["rc"] != 0 or len(resume["files"]) != args.stories:
        raise AssertionError(f"the resumed pass: {resume}")
    if sorted(resume["saved"]) != missing:
        raise AssertionError(f"the resumed pass saved {resume['saved']}, not the missing "
                             f"{missing}")
    delta = bf16_delta(args.root, model_dir, args.device, LAYERS[0])
    emit({"stage": "bf16_delta", **delta})
    if not delta["rel_to_mean_abs"] < BF16_LIMIT:
        raise AssertionError(f"bf16 features past JAX's limit: {delta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
