"""The rank side of the port's data-parallel tests.

``tests/test_torch_port_parallel.py`` and ``test_torch_port_parallel_eval.py``
start two CPU ranks with ``parallel.launch`` (gloo, a file store under the
test's temporary directory); each rank runs one of the jobs below and saves
what it computed for the test process to hold against JAX and against the
port's one-process step.  This module imports torch and the port only, so a
rank starts without JAX.  The same :func:`run_case` gives the one-process
reference in the test process (``mesh=None``).
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
from transformer_clip_eeg_tpu_torch.parallel import attach, shard_batch
from transformer_clip_eeg_tpu_torch.parallel.collectives import all_gather_rows
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
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
    for m in model.modules():
        if case.get("no_dropout") and isinstance(m, Dropout):
            m.rate = 0.0
        if case.get("no_dropout") and isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0
        if case.get("fused") and isinstance(m, BasicBlock):
            m.fused = True
    return model


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
