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
saved (``args.txt`` and ``checkpoints/model_ckpt.pt``); the serve and
server CLIs are still to port (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from transformer_clip_eeg_tpu_torch.eval.match_mismatch import embed_in_chunks
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
        self._embed_eeg, self._embed_speech = make_embed_fns(self.model)

    @classmethod
    def from_results_dir(cls, results_dir: str, chunk: int = 128,
                         device="cuda") -> "InferenceSession":
        """Serve a training run: the model built from its ``args.txt``
        (the memory bank sized by the ``bank_size`` the trainer persisted
        there) with the weights of ``checkpoints/model_ckpt.pt``."""
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
        bank_size = int(cfg.bank_size) or payload["model"]["eegMemoryBank.memory"].shape[0] - 1
        model = build_model_from_config(cfg, bank_size, device="cpu", seed=cfg.seed)
        return cls(model, payload["model"], chunk=chunk, device=device)

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
        dim = self.model.eegModel.get_output_dim(windows.shape[1])
        return embed_in_chunks(self._embed_eeg, windows, self.chunk, self.device, dim)

    def embed_speech(self, windows: np.ndarray) -> np.ndarray:
        """``[N, T, F]`` speech-feature windows → ``[N, D]`` embeddings."""
        windows = np.asarray(windows, np.float32)
        dim = self.model.speechModel.get_output_dim(windows.shape[1])
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
