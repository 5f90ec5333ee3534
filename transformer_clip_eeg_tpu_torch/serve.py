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

Under a ``mesh`` (``parallel.make_mesh``; ``--shard N`` starts N ranks) a
session replicates rank 0's weights, embeds its rows of every padded chunk
and all-gathers the chunk, so every rank returns the whole result; an index
holds its slice of the bank's rows and merges the ranks' top-k.

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
import sys
from typing import Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

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

    ``mesh`` (optional): a data-parallel mesh.  The weights are rank 0's,
    broadcast once; each rank embeds its rows of every chunk (``chunk`` must
    divide by the data axis) and the chunk is gathered, so every rank
    returns the whole result.  Every rank must embed the same windows.
    """

    def __init__(self, model, state_dict=None, chunk: int = 128, device="cuda", mesh=None):
        from transformer_clip_eeg_tpu_torch.parallel.mesh import attach, replicate

        if mesh is not None and chunk % mesh.n_data:
            raise ValueError(f"chunk {chunk} must divide by the data axis ({mesh.n_data})")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model = model.to(self.device).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.mesh = mesh
        if mesh is not None:
            attach(self.model, mesh)
            replicate(mesh, self.model.state_dict().values())
        self.chunk = chunk
        self.cfg = None  # set by from_results_dir
        self._embed_eeg, self._embed_speech = make_embed_fns(self.model)

    @classmethod
    def from_results_dir(cls, results_dir: str, chunk: int = 128,
                         device="cuda", mesh=None) -> "InferenceSession":
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
        session = cls(model, payload["model"], chunk=chunk, device=device, mesh=mesh)
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


def _ranked(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """The ``k`` best of each row of ``scores [Q, n]`` (with ``ids [Q, n]``,
    or ``[n]`` for every row), by score descending, then index ascending:
    ``lax.top_k``'s order for equal scores.  Equal scores keep their column
    order, so ``ids`` must ascend along each row wherever scores tie: a
    rank's rows do, and so does the concatenation of the ranks' results in
    rank order, since each rank's ids all lie below the next rank's."""
    order = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :k]
    return scores.gather(1, order), ids.expand_as(scores).gather(1, order)


class RetrievalIndex:
    """L2-normalised candidate bank on the device with one-matmul top-k.

    ``capacity`` rows are allocated up front; rows not yet filled score
    ``-inf``, so :meth:`add` never reallocates.

    ``mesh`` (optional): the bank's rows sharded over the data axis.  The
    capacity is rounded up to a multiple of it; rank ``r`` holds rows ``[r
    c/n, (r+1) c/n)`` and :meth:`add` writes the rows that fall there;
    :meth:`topk` takes each rank's local top-k, all-gathers the scores with
    their global indices and merges them.  Every rank must make the same
    calls with the same arguments.
    """

    def __init__(self, dim: int, capacity: int = 1024, device="cuda", mesh=None):
        self.dim = int(dim)
        self.mesh = mesh
        n = 1 if mesh is None else mesh.n_data
        self.capacity = int(-(-int(capacity) // n) * n)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        rows = self.capacity // n
        self._row0 = 0 if mesh is None else mesh.rank * rows  # this rank's first global row
        self._bank = torch.zeros(rows, self.dim, device=self.device)
        self.size = 0

    @classmethod
    def from_embeddings(cls, embeddings: np.ndarray, capacity: Optional[int] = None,
                        device="cuda", mesh=None) -> "RetrievalIndex":
        emb = np.asarray(embeddings, np.float32)
        idx = cls(emb.shape[1], capacity or max(1, emb.shape[0]), device=device, mesh=mesh)
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
        # the new global rows [size, size + n) that fall in this rank's slice
        lo = max(self.size, self._row0)
        hi = min(self.size + n, self._row0 + self._bank.shape[0])
        if lo < hi:
            self._bank[lo - self._row0:hi - self._row0] = torch.from_numpy(
                emb[lo - self.size:hi - self.size]).to(self.device)
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
        rows = torch.arange(self._row0, self._row0 + self._bank.shape[0], device=self.device)
        sims[:, rows >= self.size] = -torch.inf
        scores, ids = _ranked(sims, rows, min(k, self._bank.shape[0]))
        if self.mesh is not None:
            parts = [torch.empty_like(t) for t in (scores, ids) for _ in range(self.mesh.n_data)]
            n = self.mesh.n_data
            dist.all_gather(parts[:n], scores.contiguous(), group=self.mesh.data_group)
            dist.all_gather(parts[n:], ids.contiguous(), group=self.mesh.data_group)
            scores, ids = _ranked(torch.cat(parts[:n], 1), torch.cat(parts[n:], 1), k)
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
    ``--shard N`` serves on N data-parallel ranks (spawned here, or the
    group this process or ``torchrun`` has joined); rank 0 writes.

    Examples::

        python -m transformer_clip_eeg_tpu_torch.serve \\
            --results_folder results/run_x --eeg windows.npy --out emb.npy
        python -m transformer_clip_eeg_tpu_torch.serve \\
            --results_folder results/run_x --eeg windows.npy \\
            --candidates stim_windows.npy --topk 5 --out retrieval.json
    """
    from transformer_clip_eeg_tpu_torch.parallel import run_on_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if not args.shard:
        return _serve(args, device)
    if args.chunk % args.shard:  # JAX's check, before any rank starts
        raise ValueError(f"chunk {args.chunk} must divide by the data axis ({args.shard})")
    resolve_device(device)  # no card: raise before any rank starts
    return run_on_ranks(args.shard, _rank_main, (argv, device), device)


def _parse(argv):
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
                    help="shard each chunk and the candidate bank over N data-parallel "
                         "ranks (0 = one process)")
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
    if args.shard < 0:
        ap.error("--shard must be >= 0")
    return args


def _rank_main(argv, device, mesh) -> int:
    """One rank of ``--shard N``."""
    return _serve(_parse(argv), device, mesh)


def _serve(args, device, mesh=None) -> int:
    sess = InferenceSession.from_results_dir(args.results_folder, chunk=args.chunk,
                                             device=device, mesh=mesh)
    writer = mesh is None or mesh.is_writer
    if args.topk:
        eeg_emb = sess.embed_eeg(np.load(args.eeg), normalize=args.mvn)
        cand_emb = sess.embed_speech(np.load(args.candidates))
        index = RetrievalIndex.from_embeddings(cand_emb, device=device, mesh=mesh)
        scores, ids = index.topk(eeg_emb, args.topk)
        if writer:
            with open(args.out, "w") as f:
                json.dump({"indices": ids.tolist(),
                           "scores": [[float(x) for x in row] for row in scores]}, f)
            print(f"wrote top-{args.topk} retrieval for {len(ids)} queries to {args.out}")
        return 0
    if args.eeg:
        emb = sess.embed_eeg(np.load(args.eeg), normalize=args.mvn)
    else:
        emb = sess.embed_speech(np.load(args.speech))
    if writer:
        np.save(args.out, emb)
        print(f"wrote {emb.shape} embeddings to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
