"""Offline wav2vec2 stimulus feature extraction.

Counterpart of ``transformer_clip_eeg_tpu/preprocess/wav2vec.py``, with the
reference's behaviour (ref ``preprocess_audio/create_wav2vec.py``):

* audio ingest: ``.wav`` (scipy's reader, librosa.load semantics, resampled
  with resampy's ``kaiser_best`` filter) or ``.npz`` with ``audio``/``fs``
  (scipy's ``resample_poly``) to 16 kHz (ref ``:72-80``);
* half-overlap zero padding at the start (ref ``:88``);
* chunks of ``segment_length`` + ``overlap`` seconds (the run config used
  ``overlap=2, segment_length=8``, ref ``:146``), with the reference's loop
  that has no ``break``: once the tail is reached every remaining iteration
  appends a further, shorter tail chunk (ref ``:94-109``);
* per chunk, the hidden states at the requested layers with
  ``int(overlap/2)*50`` frames stripped from each side, one extra frame
  kept at the tail of non-final chunks (the reference's ``+1``, ref
  ``:115-119``), stacked;
* the main loop: ``stimuli/eeg/*.npz.gz`` in reverse sorted order,
  ``noise_``/``t_`` files skipped, gunzipped, extracted, resampled 50 → 64
  Hz by ``scipy.signal.resample``, saved as ``{story}_-_wav2vec_{layer}.npy``
  in float32; a story whose first layer's file exists is skipped.  The
  unzipped audio and each feature file are written under a temporary name
  and renamed when whole, a story's first layer last, so a run stopped at
  any point resumes with the stories it had not finished.

Equal-length chunks run as batches of at most ``max_chunk_batch`` (the conv
encoder's first activation is [512, 32000] floats a 10 s chunk), each slab
padded to one shape; the ragged tail chunks run one by one.  The encoder
stops at the deepest requested layer.  Weights come from a local HF
checkpoint directory, read without ``transformers``
(``models/wav2vec2.read_hf_directory``).  Runs on the card unless the
caller passes ``device="cpu"``.  Imports nothing of JAX.

``--n_data_shards`` / ``--n_model_shards`` run the extraction on a
``('data', 'model')`` mesh of ``torch.distributed`` ranks (JAX's DP x TP
grid): each slab is padded with zero rows to a multiple of the data axis,
data row ``d`` takes its rows, the ranks of that row run the encoder
Megatron-sharded (``parallel/tp.py``), and the hidden states are gathered
over the data axis with the pad rows stripped.  Rank 0 writes the files.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import math
import os
import shutil
import sys
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import scipy.signal
import torch
import torch.distributed as dist

SR = 16000
FRAMES_PER_S = 50  # wav2vec2 output rate at 16 kHz (stride 320)
FINAL_RATE_HZ = 64  # ref create_wav2vec.py:19


def kaiser_best_resample(x: np.ndarray, sr_out: int, sr_in: int) -> np.ndarray:
    """Polyphase resampling with resampy's ``kaiser_best`` filter (64 zero
    crossings, Kaiser β=14.7697, rolloff 0.9476: librosa's
    ``res_type='kaiser_best'``), the JAX package's stand-in for the
    reference's ``librosa.load``."""
    g = math.gcd(sr_out, sr_in)
    up, down = sr_out // g, sr_in // g
    if up == down:
        return np.asarray(x, np.float32)
    num_zeros, beta, rolloff = 64, 14.769656459379492, 0.9475937167399596
    # cutoff in Nyquist units of the upsampled rate fs_in·up
    c = rolloff * min(1.0 / up, 1.0 / down)
    half = int(np.ceil(num_zeros / c))
    taps = scipy.signal.firwin(2 * half + 1, c, window=("kaiser", beta))
    # resample_poly applies the `up` gain to array windows itself
    y = scipy.signal.resample_poly(x, up, down, window=taps)
    return np.asarray(y, np.float32)


def load_audio(audio_path: str, sr: int = SR) -> np.ndarray:
    """``.wav`` (int PCM scaled to [-1, 1], channels averaged, kaiser_best
    resample) or ``.npz`` (the reference's ``resample_poly`` call) audio at
    ``sr`` (ref create_wav2vec.py:72-80)."""
    if audio_path.endswith(".wav"):
        from scipy.io import wavfile

        sampling_rate, speech_array = wavfile.read(audio_path)
        if speech_array.dtype.kind == "i":
            speech_array = speech_array / float(np.iinfo(speech_array.dtype).max)
        speech_array = np.asarray(speech_array, np.float32)
        if speech_array.ndim == 2:
            speech_array = speech_array.mean(axis=1)
        if sampling_rate != sr:
            speech_array = kaiser_best_resample(speech_array, sr, sampling_rate)
        return speech_array
    speech_data = dict(np.load(audio_path, allow_pickle=True))
    speech_array = np.asarray(speech_data["audio"], np.float32).squeeze()
    sampling_rate = int(speech_data["fs"])
    if sampling_rate != sr:
        speech_array = scipy.signal.resample_poly(speech_array, sr, sampling_rate).astype(
            np.float32)
    return speech_array


class Wav2Vec2FeatureExtractor:
    """Chunked hidden-state extraction with a batched forward on the model's
    device."""

    def __init__(self, model, layers: Sequence[int] = (19,), sr: int = SR,
                 frames_per_s: int = FRAMES_PER_S, max_chunk_batch: Optional[int] = 16,
                 mesh=None):
        """``model``: a ``models.wav2vec2.Wav2Vec2Model`` on its device, in its
        compute dtype (under a mesh with a ``'model'`` axis, this rank's
        tensor-parallel slices: ``load_wav2vec2(..., mesh=mesh)``).
        ``max_chunk_batch``: the most chunks a forward takes (None:
        unbounded).  ``mesh``: a ``parallel.make_mesh`` grid; every rank of it
        must extract the same audio."""
        self.model = model
        self.layers = sorted(layers)
        self.sr = sr
        self.frames_per_s = frames_per_s
        self.max_chunk_batch = max_chunk_batch
        self.mesh = mesh
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def _forward(self, audio_batch: np.ndarray) -> Dict[int, np.ndarray]:
        """The taps of ``audio_batch``; under a mesh the batch is padded to a
        multiple of the data axis, this data row's rows run here, and the
        ranks' outputs are gathered over the data axis (JAX ``_forward``)."""
        if self.mesh is None:
            out = self.model.hidden_states(torch.from_numpy(audio_batch).to(self.device),
                                           self.layers)
            return {layer: v.cpu().numpy() for layer, v in out.items()}
        from transformer_clip_eeg_tpu_torch.parallel.collectives import all_gather_rows

        n = audio_batch.shape[0]
        pad = (-n) % self.mesh.n_data
        if pad:
            audio_batch = np.concatenate(
                [audio_batch, np.zeros((pad,) + audio_batch.shape[1:], audio_batch.dtype)])
        mine = audio_batch[self.mesh.rows(audio_batch.shape[0])]
        out = self.model.hidden_states(torch.from_numpy(mine).to(self.device), self.layers)
        return {layer: all_gather_rows(v, self.mesh)[:n].cpu().numpy()
                for layer, v in out.items()}

    def get_hidden_output(self, audio: Union[str, np.ndarray], overlap: int = 2,
                          segment_length: int = 8) -> Dict[int, np.ndarray]:
        """Ref create_wav2vec.py:68-123 (the same chunk and strip
        arithmetic)."""
        sr = self.sr
        if isinstance(audio, str):
            speech_array = load_audio(audio, sr=sr)
        else:
            speech_array = np.asarray(audio, np.float32).squeeze()
        wav_length = speech_array.size

        half = int(overlap / 2)
        padded = np.concatenate([np.zeros(half * sr, np.float32), speech_array])
        seg = segment_length * sr
        chunk_len = seg + overlap * sr
        n_chunks = int(wav_length / seg) + 1

        # the reference's loop has no break: once the tail is reached, every
        # remaining iteration appends a further tail chunk
        full_chunks: List[np.ndarray] = []
        tail_chunks: List[np.ndarray] = []
        for i in range(n_chunks):
            start = i * seg
            end = start + chunk_len
            if not tail_chunks and end < padded.size:
                full_chunks.append(padded[start:end])
            else:
                tail_chunks.append(padded[start:])

        outputs: Dict[int, List[np.ndarray]] = {layer: [] for layer in self.layers}
        strip = half * self.frames_per_s
        if full_chunks:
            batch = np.stack(full_chunks)
            n = batch.shape[0]
            mb = self.max_chunk_batch or n
            for s in range(0, n, mb):
                slab = batch[s:s + mb]
                real = slab.shape[0]
                if n > mb and real < mb:  # one shape for every slab
                    slab = np.concatenate(
                        [slab, np.zeros((mb - real,) + slab.shape[1:], slab.dtype)])
                outs = self._forward(slab)
                for layer in self.layers:
                    arr = np.asarray(outs[layer], np.float32)[:real]
                    for out in arr:
                        # non-final: strip both sides, the +1 tail quirk (ref :119)
                        outputs[layer].append(out[strip:out.shape[0] - strip + 1])
        for tail in tail_chunks:
            if tail.size == 0:
                continue
            outs = self._forward(tail[None, :])
            for layer in self.layers:
                outputs[layer].append(np.asarray(outs[layer], np.float32)[0][strip:])
        return {layer: np.vstack(v) for layer, v in outputs.items()}


@contextlib.contextmanager
def _replaced_on_close(path: str):
    """A binary file that appears at ``path`` whole or not at all: written
    under a temporary name beside it and renamed once closed, so a run
    stopped mid-write leaves no partial file for the skip rule to keep."""
    tmp = f"{path}.partial"
    try:
        with open(tmp, "wb") as f:
            yield f
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def extract_stimulus_features(extractor: Wav2Vec2FeatureExtractor, stimuli_dir: str,
                              save_dir: str, overlap: int = 2, segment_length: int = 8,
                              final_rate_hz: int = FINAL_RATE_HZ) -> List[str]:
    """The reference's main loop (ref create_wav2vec.py:128-158); returns the
    paths saved.  Under the extractor's mesh every rank extracts every story
    and rank 0 alone unzips, prints and writes."""
    mesh = extractor.mesh
    writer = mesh is None or mesh.is_writer
    say = print if writer else (lambda *a, **k: None)
    os.makedirs(save_dir, exist_ok=True)
    audio_paths = sorted(glob.glob(os.path.join(stimuli_dir, "*.npz.gz")), reverse=True)
    audio_paths = [x for x in audio_paths
                   if not os.path.basename(x).startswith(("noise_", "t_"))]
    say(f"Found {len(audio_paths)} audio files.")
    saved: List[str] = []
    first_layer = extractor.layers[0]
    for path in audio_paths:
        story = os.path.basename(path).split(".")[0]
        say("Processing", story)
        unzipped_name = path.rsplit(".gz", 1)[0]
        if writer and not os.path.exists(unzipped_name):
            with gzip.open(path, "rb") as f_in, _replaced_on_close(unzipped_name) as f_out:
                shutil.copyfileobj(f_in, f_out)
        # the other ranks read the file rank 0 unzipped, and take the same
        # skip decision (rank 0 writes a story's files only after every rank
        # has extracted it)
        skip = os.path.exists(os.path.join(save_dir, f"{story}_-_wav2vec_{first_layer}.npy"))
        if mesh is not None:
            dist.barrier()
        if skip:
            continue
        features = extractor.get_hidden_output(unzipped_name, overlap=overlap,
                                               segment_length=segment_length)
        if not writer:
            continue
        # the files are renamed into place in reverse, so the first layer's,
        # which the skip rule reads, appears only once the others have
        story_saved = []
        with contextlib.ExitStack() as files:
            for layer, value in features.items():
                number_of_samples = round(value.shape[0] * float(final_rate_hz)
                                          / extractor.frames_per_s)
                value = scipy.signal.resample(value, number_of_samples)
                save_name = os.path.join(save_dir, f"{story}_-_wav2vec_{layer}.npy")
                np.save(files.enter_context(_replaced_on_close(save_name)), value)
                story_saved.append(save_name)
        for save_name in story_saved:
            print(f"Saved to '{save_name}'.")
        saved += story_saved
    return saved


def build_arg_parser():
    import argparse

    p = argparse.ArgumentParser(prog="python -m transformer_clip_eeg_tpu_torch.preprocess.wav2vec",
                                description="Extract wav2vec2 features for a SparrKULee tree.")
    p.add_argument("--dataset_root", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True,
                   help="local HF wav2vec2 checkpoint dir (config.json and "
                        "pytorch_model.bin or model.safetensors)")
    p.add_argument("--layers", type=int, nargs="+", default=[19])
    p.add_argument("--overlap", type=int, default=2)
    p.add_argument("--segment_length", type=int, default=8)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the extraction forward; parameters stay float32 "
                        "and the saved features are float32")
    p.add_argument("--max_chunk_batch", type=int, default=16,
                   help="max chunks per forward (0 = unbounded); bounds the conv "
                        "encoder's activation memory on long stories")
    p.add_argument("--n_data_shards", type=int, default=0,
                   help="shard chunk batches over a 'data' axis of this many ranks (0 = one "
                        "process, or the cards over --n_model_shards when that is > 1)")
    p.add_argument("--n_model_shards", type=int, default=1,
                   help="Megatron-shard the encoder over a 'model' axis of this many ranks "
                        "(parallel/tp.py); must divide the head count and FFN width")
    p.add_argument("--split_programs", type=str, default="no", choices=["yes", "no"],
                   help="accepted and without effect: it splits the JAX package's XLA "
                        "program, and the port compiles none")
    p.add_argument("--scan_layers", type=str, default="yes", choices=["yes", "no"],
                   help="accepted and without effect: it shapes the JAX package's XLA "
                        "program, and the port compiles none")
    return p


def _grid(args, config, device) -> tuple:
    """``(n_data, n_model)`` of the flags; ``--n_data_shards 0`` with a
    ``'model'`` axis is the devices over ``n_model`` (JAX's ``len(devices)
    // n_model``): the ranks of a joined group, else the cards of a CUDA
    job, else the one host."""
    from transformer_clip_eeg_tpu_torch.parallel.tp import validate_tp

    n_model = args.n_model_shards
    if n_model < 1 or args.n_data_shards < 0:
        raise ValueError(f"--n_data_shards {args.n_data_shards} / --n_model_shards {n_model}: "
                         "counts must be >= 0 and >= 1")
    validate_tp(config, n_model)
    n_data = args.n_data_shards
    if not n_data:
        if dist.is_initialized():
            devices = dist.get_world_size()
        elif torch.device(device).type == "cuda":
            devices = torch.cuda.device_count()
        else:
            devices = 1
        n_data = devices // n_model
        if not n_data:
            raise ValueError(f"--n_data_shards 0 takes the devices over --n_model_shards "
                             f"{n_model}, and {devices} device(s) make none: pass "
                             "--n_data_shards explicitly")
    return n_data, n_model


def main(argv=None, device="cuda") -> int:
    """CLI: extract wav2vec features for a SparrKULee download tree into
    ``<dataset_root>/derivatives/preprocessed_stimuli``, on the card unless
    ``device="cpu"``; with ``--n_data_shards`` / ``--n_model_shards`` on a
    mesh of ranks (spawned here, or the group this process or ``torchrun``
    has joined)."""
    from transformer_clip_eeg_tpu_torch.models.registry import resolve_device
    from transformer_clip_eeg_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from transformer_clip_eeg_tpu_torch.parallel import run_on_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    if not args.n_data_shards and args.n_model_shards == 1:
        return _extract(args, device)
    resolve_device(device)  # no card: raise before any rank starts
    with open(os.path.join(args.model_path, "config.json")) as f:
        config = Wav2Vec2Config.from_hf(json.load(f))
    n_data, n_model = _grid(args, config, device)
    return run_on_ranks(n_data * n_model, _rank_main, (argv, device), device, n_model)


def _rank_main(argv, device, mesh) -> int:
    """One rank of :func:`main`'s mesh."""
    return _extract(build_arg_parser().parse_args(argv), device, mesh)


def _extract(args, device, mesh=None) -> int:
    from transformer_clip_eeg_tpu_torch.models.wav2vec2 import load_wav2vec2

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    model = load_wav2vec2(args.model_path, device=device, dtype=dtype, mesh=mesh)
    extractor = Wav2Vec2FeatureExtractor(model, args.layers,
                                         max_chunk_batch=args.max_chunk_batch or None,
                                         mesh=mesh)
    extract_stimulus_features(
        extractor, os.path.join(args.dataset_root, "stimuli", "eeg"),
        os.path.join(args.dataset_root, "derivatives", "preprocessed_stimuli"),
        overlap=args.overlap, segment_length=args.segment_length)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
