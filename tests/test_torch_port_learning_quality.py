"""Torch port, the learning-quality gate (``tools/learning_quality.py``) on
the CPU: JAX's in-suite gate (``tests/test_learning_quality.py``: depth 2,
latent 4, 16 LSTM units, batch 8, 12 epochs on the correlated fixture)
through ``run_gate`` at JAX's thresholds, and the gate's first epoch against
JAX's ``Trainer`` from the same initial weights, on the same batches."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from transformer_clip_eeg_tpu.data.dataset import EEGWindowDataset as JDataset
from transformer_clip_eeg_tpu.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.train import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train import Trainer as JTrainer
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout
from transformer_clip_eeg_tpu_torch.tools import learning_quality as lq
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

DEPTH2 = dict(attention_depth=2, latent_dim=4, lstm_units=16)  # JAX's in-suite gate
VAL_CE_TOL = 1e-4  # of max(1, |CE|), as tests/test_torch_port_fold_parallel.py holds it


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_depth2_gate_clears_jax_thresholds(tmp_path):
    """The contrastive CE falls well below the ln 8 = 2.08 plateau (< 1.4),
    match-mismatch accuracy >= 0.7 (chance 0.5), top-1 retrieval over 12
    candidates >= 0.3 (chance 1/12): JAX's numbers, not the tool's."""
    rec = lq.run_gate(str(tmp_path), **DEPTH2, device="cpu")
    assert len(rec["val_loss_ce"]) == 12 and rec["device"] == "cpu"
    assert rec["best_val_loss_ce"] == min(rec["val_loss_ce"])
    assert rec["best_val_loss_ce"] < 1.4, rec["val_loss_ce"]
    assert rec["mm_mean_accuracy"] >= 0.7, rec
    assert rec["top1_retrieval"] >= 0.3, rec
    assert rec["passed"]


def test_gate_refuses_a_run_directory_it_would_resume(tmp_path):
    lq.fixture_root(str(tmp_path))
    (tmp_path / "run_float32_depth2").mkdir()
    with pytest.raises(FileExistsError, match="from scratch"):
        lq.make_trainer(str(tmp_path), **DEPTH2, device="cpu")


def test_gate_without_a_card_raises_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lq.run_gate(str(tmp_path / "w"), **DEPTH2)
    assert not (tmp_path / "w").exists()


class _NoDropout(jl.Dropout):
    """JAX's flax Dropout as the identity: its masks cannot be drawn in torch."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _port_without_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        if isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0


def test_first_epoch_matches_jax_trainer(tmp_path):
    """One epoch of the gate (18 AdamW steps at batch 8, then validation) in
    both trainers, from JAX's initial variables carried across, dropout off
    on both sides: the validation CE within 1e-4 of max(1, |CE|)."""
    port = lq.make_trainer(str(tmp_path), **DEPTH2, epochs=1, device="cpu")
    root = port.cfg.data_dir
    jcfg = JConfig(data_dir=root, run=0, batch_size=8, epochs=1, patience=1, **DEPTH2,
                   number_of_training_subjects=3, speech_dim_override=16, lr_scheduler="no")
    files = get_train_val_test_files_final(root, 0, "wav2vec_19", jcfg.fold_split_path, 3)
    jtrain = JDataset(files[0], files[4], 192, 192, batch_size=8, shuffle=True,
                      shuffle_percentage=1.0, seed=0)
    jval = JDataset(files[1], files[5], 192, 192, batch_size=8, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        for module in (je, ja, jh):
            mp.setattr(module, "Dropout", _NoDropout)
        jt = JTrainer(jcfg, jtrain, jval, results_dir=str(tmp_path / "jax_run"))
        init = jax.tree.map(np.array, dict(jt.state.variables))
        want = jt.fit()
    port.model.load_state_dict(state_dict_from_jax(init, port.model))
    _port_without_dropout(port.model)
    got = port.fit()
    a, b = got["history"][0]["val_loss_ce"], want["history"][0]["val_loss_ce"]
    assert abs(a - b) <= VAL_CE_TOL * max(1.0, abs(b)), (a, b)
    assert a < 2.0  # the epoch trained: below the ln 8 plateau
