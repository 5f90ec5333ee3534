"""Serving: embed EEG and speech windows, retrieve, decide match-mismatch.

Counterpart of ``transformer_clip_eeg_tpu/serve.py``:

* :func:`build_model_from_config` assembles the model from a ``TrainConfig``
  alone, with weights drawn from a seeded ``torch.Generator``;
* :class:`InferenceSession` holds a model and its weights on one device and
  streams windows through it in fixed-size padded chunks;
* :class:`RetrievalIndex` is an L2-normalised candidate bank allocated on the
  device up front; top-k is one ``queries @ bank.T`` matmul plus
  ``torch.topk``;
* :func:`match_mismatch_decide` is the 2-candidate decision of the ICASSP
  task.

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; asking for the card on a host without one raises.
:meth:`InferenceSession.from_results_dir` serves what the port's trainer
saved (``args.txt`` and ``checkpoints/model_ckpt.pt``); :func:`main` is
the batch command line over it (``python -m
transformer_clip_eeg_tpu_torch.serve``), and ``server.py`` the HTTP one.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.eval.match_mismatch import embed_in_chunks
from transformer_clip_eeg_tpu_torch.models.heads import embedding_width
from transformer_clip_eeg_tpu_torch.models.registry import (
    build_model_from_config,
    resolve_device,
)
from transformer_clip_eeg_tpu_torch.train.steps import make_embed_fns


class InferenceSession:
    """A model and its weights on one device, ready to serve.

    ``state_dict`` (optional) replaces the model's weights, e.g. the output
    of ``utils.convert.state_dict_from_jax``.  ``chunk`` is the fixed batch:
    inputs of any length are padded to a multiple of it.
    """

    def __init__(self, model, state_dict=None, chunk: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.chunk = chunk
        self.cfg = None  # set by from_results_dir
        self._embed_eeg, self._embed_speech = make_embed_fns(self.model)

    @classmethod
    def from_results_dir(cls, results_dir: str, chunk: int = 128,
                         device="cuda") -> "InferenceSession":
        """Serve a training run: the model built from its ``args.txt``
        with the weights of ``checkpoints/model_ckpt.pt``.  The head is sized
        by the ``bank_size`` the trainer persisted in ``args.txt``, else by
        the checkpoint's memory bank; with neither it raises ``ValueError``."""
        from transformer_clip_eeg_tpu_torch.train.checkpoint import (
            checkpoint_path,
            load_checkpoint,
        )
        from transformer_clip_eeg_tpu_torch.train.config import TrainConfig

        cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
        ckpt_dir = os.path.join(results_dir, "checkpoints")
        payload = load_checkpoint(ckpt_dir)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint at {checkpoint_path(ckpt_dir)}")
        bank = payload["model"].get("eegMemoryBank.memory")
        if cfg.bank_size:
            # the trainer persists its sizing in args.txt: the only source
            # for the heads without a bank (clip_kld*, no_contrastive_learning)
            bank_size = int(cfg.bank_size)
        elif bank is not None:
            bank_size = bank.shape[0] - 1
        else:
            raise ValueError(
                f"cannot size the {cfg.model_arch!r} head: args.txt has no bank_size and "
                "the checkpoint holds no memory bank to infer it from; add "
                "\"bank_size\": <number of stimulus segments> to args.txt")
        model = build_model_from_config(cfg, bank_size, device="cpu", seed=cfg.seed)
        session = cls(model, payload["model"], chunk=chunk, device=device)
        session.cfg = cfg  # the run's config, for callers that surface model info
        return session

    def embed_eeg(self, windows: np.ndarray, normalize: bool = False) -> np.ndarray:
        """``[N, T, 64]`` EEG windows → ``[N, D]`` L2-normalised embeddings.

        ``normalize=True`` first applies the eval-time MVN over the
        (segments, time) axes, on the host.
        """
        windows = np.asarray(windows, np.float32)
        if normalize:
            mu = windows.mean(axis=(0, 1), keepdims=True)
            sd = windows.std(axis=(0, 1), keepdims=True)
            windows = (windows - mu) / np.where(sd == 0, 1.0, sd)
        dim = embedding_width(self.model.eegModel, windows.shape[1])
        return embed_in_chunks(self._embed_eeg, windows, self.chunk, self.device, dim)

    def embed_speech(self, windows: np.ndarray) -> np.ndarray:
        """``[N, T, F]`` speech-feature windows → ``[N, D]`` embeddings."""
        windows = np.asarray(windows, np.float32)
        dim = embedding_width(self.model.speechModel, windows.shape[1])
        return embed_in_chunks(self._embed_speech, windows, self.chunk, self.device, dim)


class RetrievalIndex:
    """L2-normalised candidate bank on the device with one-matmul top-k.

    ``capacity`` rows are allocated up front; rows not yet filled score
    ``-inf``, so :meth:`add` never reallocates.
    """

    def __init__(self, dim: int, capacity: int = 1024, device="cuda"):
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self._bank = torch.zeros(self.capacity, self.dim, device=self.device)
        self.size = 0

    @classmethod
    def from_embeddings(cls, embeddings: np.ndarray, capacity: Optional[int] = None,
                        device="cuda") -> "RetrievalIndex":
        emb = np.asarray(embeddings, np.float32)
        idx = cls(emb.shape[1], capacity or max(1, emb.shape[0]), device=device)
        idx.add(emb)
        return idx

    def add(self, embeddings: np.ndarray) -> np.ndarray:
        """Append rows (assumed L2-normalised, as the embedders produce);
        returns their indices."""
        emb = np.asarray(embeddings, np.float32)
        n = emb.shape[0]
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"embeddings must be [N, {self.dim}], got {emb.shape}")
        if self.size + n > self.capacity:
            raise ValueError(
                f"index full: size={self.size}, adding {n}, capacity={self.capacity}"
            )
        self._bank[self.size:self.size + n] = torch.from_numpy(emb).to(self.device)
        ids = np.arange(self.size, self.size + n)
        self.size += n
        return ids

    def topk(self, queries: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """``[Q, D]`` queries → (scores ``[Q, k]``, indices ``[Q, k]``)."""
        if self.size == 0:
            raise ValueError("index is empty")
        k = min(k, self.size)
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        sims = q @ self._bank.T
        sims[:, self.size:] = -torch.inf
        scores, ids = torch.topk(sims, k, dim=1)
        return scores.cpu().numpy(), ids.cpu().numpy()


def match_mismatch_decide(
    eeg_emb: np.ndarray, cand_a: np.ndarray, cand_b: np.ndarray
) -> np.ndarray:
    """2-candidate decision per trial: 0 if candidate A matches, else 1."""
    sim_a = np.sum(eeg_emb * cand_a, axis=1)
    sim_b = np.sum(eeg_emb * cand_b, axis=1)
    return (sim_b > sim_a).astype(np.int32)


def main(argv=None, device="cuda") -> int:
    """Batch serving CLI: embed ``.npy`` EEG/speech windows with a trained
    run; optionally retrieve top-k candidates for each EEG window.

    Examples::

        python -m transformer_clip_eeg_tpu_torch.serve \\
            --results_folder results/run_x --eeg windows.npy --out emb.npy
        python -m transformer_clip_eeg_tpu_torch.serve \\
            --results_folder results/run_x --eeg windows.npy \\
            --candidates stim_windows.npy --topk 5 --out retrieval.json
    """
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--results_folder", required=True,
                    help="training run directory (args.txt + checkpoints/)")
    ap.add_argument("--eeg", help=".npy of [N, T, 64] EEG windows")
    ap.add_argument("--speech", help=".npy of [N, T, F] speech windows")
    ap.add_argument("--candidates",
                    help=".npy of [M, T, F] candidate speech windows")
    ap.add_argument("--topk", type=int, default=0)
    ap.add_argument("--mvn", action="store_true",
                    help="apply eval-time MVN normalization to the EEG")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--shard", type=int, default=0,
                    help="shard each chunk over N data-parallel devices "
                         "(0 = single device; more is not ported)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--compile_cache_dir", type=str, default="",
                    help="the JAX package's compilation cache; the port "
                         "compiles no programs per run, so it is ignored")
    args = ap.parse_args(argv)

    # retrieval needs the full (--eeg, --candidates, --topk) triple
    retrieval = (bool(args.topk), bool(args.candidates))
    if any(retrieval) and not (all(retrieval) and args.eeg):
        ap.error("retrieval requires --eeg, --candidates AND --topk together")
    if not args.topk:
        if args.eeg and args.speech:
            ap.error("--eeg and --speech are mutually exclusive in embed-only mode "
                     "(use --topk with --eeg/--candidates for retrieval)")
        if not (args.eeg or args.speech):
            ap.error("one of --eeg / --speech is required")
    if args.shard:
        raise NotImplementedError(
            "--shard > 0 (data-parallel serving over several devices) is not ported to "
            "the torch package yet (ROADMAP.md §2, multi-device)")

    sess = InferenceSession.from_results_dir(args.results_folder, chunk=args.chunk,
                                             device=device)
    if args.topk:
        eeg_emb = sess.embed_eeg(np.load(args.eeg), normalize=args.mvn)
        cand_emb = sess.embed_speech(np.load(args.candidates))
        index = RetrievalIndex.from_embeddings(cand_emb, device=device)
        scores, ids = index.topk(eeg_emb, args.topk)
        with open(args.out, "w") as f:
            json.dump({"indices": ids.tolist(),
                       "scores": [[float(x) for x in row] for row in scores]}, f)
        print(f"wrote top-{args.topk} retrieval for {len(ids)} queries to {args.out}")
        return 0
    if args.eeg:
        emb = sess.embed_eeg(np.load(args.eeg), normalize=args.mvn)
    else:
        emb = sess.embed_speech(np.load(args.speech))
    np.save(args.out, emb)
    print(f"wrote {emb.shape} embeddings to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
