"""The rank side of the port's multi-process tests.

``tests/test_torch_port_parallel.py``, ``test_torch_port_parallel_eval.py``,
``test_torch_port_serve_shard.py``, ``test_torch_port_fold_mesh.py`` and
``test_torch_port_wav2vec2_tp.py`` start CPU ranks with ``parallel.launch``
(gloo, a file store under the test's temporary directory); each rank runs
one of the jobs below and saves what it computed for the test process to
hold against JAX and against the port's one-process path.  This module
imports torch and the port only, so a rank starts without JAX.  The same
functions give the one-process reference in the test process
(``mesh=None``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from transformer_clip_eeg_tpu_torch.models.encoders import BasicBlock, SpeechSmallConv
from transformer_clip_eeg_tpu_torch.models.heads import CLIPSimNoLatentProj
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout, l2_normalize
from transformer_clip_eeg_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from transformer_clip_eeg_tpu_torch.parallel import attach, shard_batch
from transformer_clip_eeg_tpu_torch.parallel.tp import shard_wav2vec2_state_dict
from transformer_clip_eeg_tpu_torch.preprocess.wav2vec import Wav2Vec2FeatureExtractor
from transformer_clip_eeg_tpu_torch.serve import InferenceSession, RetrievalIndex
from transformer_clip_eeg_tpu_torch.parallel.collectives import all_gather_rows
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer
from transformer_clip_eeg_tpu_torch.train.state import Optimizer, check_replicas
from transformer_clip_eeg_tpu_torch.train.steps import train_step

THREADS = 2  # intra-op threads a rank: the suite runs test files side by side


def tiny_model(bank_size: int = 64) -> CLIPSimNoLatentProj:
    """JAX ``tests/test_parallel.py``'s ``tiny_model`` in the port."""
    eeg = SpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                          speech_dim=64, time_dimension=32)
    speech = SpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                             speech_dim=8, time_dimension=32)
    return CLIPSimNoLatentProj(eeg, speech, bank_size=bank_size,
                               latent_dim=speech.get_output_dim(32), temperature=0.075,
                               window_length=32)


def build_case_model(case: Dict):
    """The case's model on the CPU: ``tiny`` or a ``TrainConfig``'s, its
    weights from ``case['state']`` where given, in ``case['dtype']``
    (float32 by default), dropout off for ``no_dropout``, the square conv
    blocks fused for ``fused``."""
    if case["model"] == "tiny":
        model = tiny_model()
    else:
        model = build_model_from_config(TrainConfig(**case["config"]), case["bank_size"],
                                        device="cpu", seed=case.get("init_seed", 1))
    if "state" in case:
        model.load_state_dict(case["state"])
    model.to(case.get("dtype", torch.float32))
    if case.get("no_dropout"):
        without_dropout(model)
    for m in model.modules():
        if case.get("fused") and isinstance(m, BasicBlock):
            m.fused = True
    return model


def without_dropout(model) -> None:
    """Every dropout of ``model`` off (flax's Dropout, patched to the
    identity on the JAX side, cannot be matched)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        if isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0


class RecordingOptimizer(Optimizer):
    """The port's optimizer, keeping a copy of each step's gradients (the
    ranks' mean under a mesh) before it applies them."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.grads: List[List[torch.Tensor]] = []

    def apply(self, grads):
        self.grads.append([g.detach().clone() for g in grads])
        super().apply(grads)


def run_case(case: Dict, mesh=None) -> Dict:
    """The case's train steps, on ``mesh``'s rows of each global batch (the
    whole batch without a mesh): losses, gradients before the update,
    parameters and buffers after, and, under a mesh, the replicas' checksum."""
    model = build_case_model(case)
    attach(model, mesh)
    # JAX's make_optimizer("adamw", 1e-3): weight decay 0.01
    opt = RecordingOptimizer(model.parameters(), 1e-3, weight_decay=0.01)
    step_kw = case.get("step", {})
    losses = []
    dtype = case.get("dtype", torch.float32)
    for batch in case["batches"]:
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        local = batch if mesh is None else shard_batch(mesh, batch)
        out = train_step(model, opt, local, case.get("seed", 7), warmup=False, **step_kw)
        losses.append({k: float(v) for k, v in out.items()})
    result = {"losses": losses, "grads": opt.grads,
              "names": [n for n, _ in model.named_parameters()],
              "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    if mesh is not None:
        result["checksum"] = check_replicas(mesh, model, opt)
    return result


def global_infonce_statistic(mesh, b: int = 16, d: int = 4) -> float:
    """JAX ``tests/test_multihost.py``'s statistic: the sum of the global
    batch's cosine similarities, each rank holding its rows."""
    full = torch.arange(b * d, dtype=torch.float32).reshape(b, d) + 1.0
    xn = l2_normalize(all_gather_rows(full[mesh.rows(b)], mesh), 1)
    return float((xn @ xn.T).sum())


def step_job(case_path: str, mesh) -> int:
    """Every case of ``case_path`` on this rank; saves ``rank<r>.pt`` beside
    it."""
    torch.set_num_threads(THREADS)
    cases = torch.load(case_path, weights_only=False)
    out = {"infonce": global_infonce_statistic(mesh),
           "cases": {name: run_case(case, mesh) for name, case in cases.items()}}
    torch.save(out, os.path.join(os.path.dirname(case_path), f"rank{mesh.rank}.pt"))
    return 0


def single_rank_job(case_path: str, mesh) -> int:
    """The cases on a group of one, beside the same cases without a mesh,
    saved as ``n1.pt``."""
    cases = torch.load(case_path, weights_only=False)
    out = {name: (run_case(case, mesh), run_case(case, None)) for name, case in cases.items()}
    torch.save(out, os.path.join(os.path.dirname(case_path), "n1.pt"))
    return 0


def cli_job(argv: List[str], probe_epochs: int, mesh) -> int:
    """``cli.main(argv, device="cpu")`` on this rank, which joins the group,
    with the eval suite's probes trained ``probe_epochs`` epochs (the
    reference's 250 are minutes on the CPU)."""
    from transformer_clip_eeg_tpu_torch import cli
    from transformer_clip_eeg_tpu_torch.eval import regression as reg

    torch.set_num_threads(THREADS)
    batched = reg.train_regression_probes_batched
    reg.train_regression_probes_batched = \
        lambda *a, **k: batched(*a, **{**k, "epochs": probe_epochs})
    return cli.main(argv, device="cpu")


# -- sharded serving (test_torch_port_serve_shard.py) -------------------------


def index_ops(case: Dict, mesh=None) -> list:
    """``RetrievalIndex.from_embeddings(bank, capacity)`` on ``mesh``'s ranks
    (or one process), then ``case['ops']`` in turn: ``("topk", k)`` or
    ``("add", rows)``; returns the capacity and each op's result."""
    idx = RetrievalIndex.from_embeddings(case["bank"], capacity=case["capacity"],
                                         device="cpu", mesh=mesh)
    out = [idx.capacity]
    for op, arg in case["ops"]:
        out.append(idx.topk(case["queries"], arg) if op == "topk" else idx.add(arg))
    return out


def session_embeddings(case: Dict, mesh=None) -> Dict:
    """The case's windows through an ``InferenceSession`` of its weights on
    ``mesh``'s ranks (or one process)."""
    model = build_case_model({"model": "config", "config": case["config"],
                              "bank_size": case["bank_size"]})
    state = case["state"]
    if mesh is not None and not mesh.is_writer:
        # another rank's weights are replaced by rank 0's broadcast
        state = {k: v + 1.0 if v.is_floating_point() else v for k, v in state.items()}
    sess = InferenceSession(model, state, chunk=case["chunk"], device="cpu", mesh=mesh)
    return {"eeg": sess.embed_eeg(case["eeg"]),
            "eeg_mvn": sess.embed_eeg(case["eeg"], normalize=True),
            "speech": sess.embed_speech(case["speech"])}


def serve_job(case_path: str, mesh) -> int:
    """The case's sharded session and index on this rank; saves
    ``serve_rank<r>.pt``."""
    torch.set_num_threads(THREADS)
    case = torch.load(case_path, weights_only=False)
    out = {"session": session_embeddings(case, mesh),
           "index": {name: index_ops(c, mesh) for name, c in case["index"].items()}}
    torch.save(out, os.path.join(os.path.dirname(case_path), f"serve_rank{mesh.rank}.pt"))
    return 0


# -- the fold-sharded mesh (test_torch_port_fold_mesh.py) ---------------------


def fold_trainer(case: Dict, out_dir: str, mesh=None) -> FoldParallelTrainer:
    """The case's ``FoldParallelTrainer`` (``row_bucket=1``) from its
    carried weights with dropout off, on ``mesh``'s ranks or in one process."""
    trainer = FoldParallelTrainer(TrainConfig(**case["config"]), case["folds"],
                                  *case["union"], out_dir, row_bucket=1, device="cpu",
                                  mesh=mesh)
    for model in trainer.models:
        if model is not None:
            model.load_state_dict(case["state"])
            without_dropout(model)
    return trainer


def fold_mesh_job(case_path: str, out_dir: str, mesh) -> int:
    """The case's folds on this rank's share of the mesh: ``fit``'s result
    and this rank's folds' best states, saved as ``fold_rank<r>.pt``."""
    torch.set_num_threads(THREADS)
    case = torch.load(case_path, weights_only=False)
    trainer = fold_trainer(case, out_dir, mesh)
    result = trainer.fit()
    best = {trainer.folds[j]: {k: v.detach().clone()
                               for k, v in trainer.models[j].state_dict().items()}
            for j in trainer.local}
    try:
        trainer.fold_state(trainer.folds[(trainer.local[-1] + 1) % len(trainer.folds)])
        others = "returned"
    except ValueError as e:
        others = str(e)
    torch.save({"result": result, "best": best, "local": trainer.local, "others": others},
               os.path.join(os.path.dirname(case_path), f"fold_rank{mesh.rank}.pt"))
    return 0


def cv_job(argv: List[str], probe_epochs: int, mesh) -> int:
    """``cv.main(argv, device="cpu")`` on this rank, which joins the group,
    with the suites' probes trained ``probe_epochs`` epochs."""
    from transformer_clip_eeg_tpu_torch import cv
    from transformer_clip_eeg_tpu_torch.eval import regression as reg

    torch.set_num_threads(THREADS)
    batched = reg.train_regression_probes_batched
    reg.train_regression_probes_batched = \
        lambda *a, **k: batched(*a, **{**k, "epochs": probe_epochs})
    return cv.main(argv, device="cpu")


def fold_mesh_and_cv_job(case_path: str, out_dir: str, cv_argv: List[str], probe_epochs: int,
                         mesh) -> int:
    """``fold_mesh_job``, then ``cv_job`` in the same ranks: the one launched
    pair of ``test_torch_port_fold_mesh.py``."""
    return fold_mesh_job(case_path, out_dir, mesh) or cv_job(cv_argv, probe_epochs, mesh)


# -- the tensor-parallel wav2vec2 extraction (test_torch_port_wav2vec2_tp.py) ---


def tp_extraction(case: Dict, mesh=None) -> Dict[int, "object"]:
    """The case's audio through a ``Wav2Vec2FeatureExtractor`` of its
    weights: this rank's Megatron slices under ``mesh``, the whole model
    without."""
    config = case["config"]
    state = case["state"]
    tp_group = None if mesh is None else mesh.tp_group
    if tp_group is not None:
        state = shard_wav2vec2_state_dict(state, mesh.n_model, mesh.model_rank)
    model = Wav2Vec2Model(config, tp_group=tp_group)
    model.load_state_dict(state)
    ext = Wav2Vec2FeatureExtractor(model.eval(), case["layers"], sr=case["sr"],
                                   frames_per_s=case["frames_per_s"],
                                   max_chunk_batch=case.get("max_chunk_batch"), mesh=mesh)
    return ext.get_hidden_output(case["audio"], overlap=2, segment_length=case["segment"])


def tp_job(case_path: str, mesh) -> int:
    """The extraction on this rank of an ``n_data`` x ``n_model`` mesh; saves
    ``tp_<n_data>x<n_model>_rank<r>.pt`` with the rank's shapes of the
    sharded weights."""
    torch.set_num_threads(THREADS)
    case = torch.load(case_path, weights_only=False)
    out = tp_extraction(case, mesh)
    rank = mesh.rank * mesh.n_model + mesh.model_rank
    torch.save({"taps": out, "grid": (mesh.rank, mesh.model_rank)},
               os.path.join(os.path.dirname(case_path),
                            f"tp_{mesh.n_data}x{mesh.n_model}_rank{rank}.pt"))
    return 0
