"""Torch port, the bf16 compute mode in training (``--compute_dtype bfloat16``)
on the CPU:

* one flagship train step (depth 2, small widths) against JAX's
  ``make_train_step(..., compute_dtype='bfloat16')``, on the host path and on
  the device chunk store (a bf16 store: gathered, upcast, cast again);
* one bf16 step of each zoo configuration Z1-Z6 (PERF.md §4) against JAX's;
* bf16 against float32 on the port's side after 3 AdamW steps (the port's
  counterpart of JAX's ``test_bf16_step_close_to_f32``);
* ``cli.main --compute_dtype bfloat16``: it trains, ``args.txt`` keeps the
  mode, the validation steps run float32, and the evaluation suite runs.

The JAX model runs as it runs on a TPU: the fused block and the LSTM through
their Pallas kernels in interpret mode (on the CPU their default is the XLA
path, whose bf16 arithmetic is another function), with dropout off on both
sides (JAX's draws cannot be made in torch; flax's Dropout is the identity
and the fused blocks run without masks), the batch norms on batch statistics.

Limits (the bf16 mode's agreed tolerances for a whole step): each loss within
1e-2 relative; each gradient within 5e-2 of its largest value, where a leaf
that is zero in exact arithmetic (each block's key bias) is held at a floor
of one bf16 unit (4e-3) of the largest gradient; the bank's rows and the
running statistics within 1e-2.  The leaves that bf16 rounding itself moves
further than 5e-2 at this tiny batch are named in ``ROUNDING_BOUND_LEAVES``,
each held at its own limit, about 1.3x the error measured: the flagship's
last bias, whose gradient XLA's CPU backend sums over the rows in bf16
(JAX's own bf16 step moves it 6.0e-2 from its float32 one); Z4's and Z5's
convolution and batch-norm leaves and Z4's ``eeg_td1`` (one ReLU unit that
a rounding one unit apart switches at one row of the batch: every entry off
by more than 5e-2 lies in that unit's row); and Z6's VLAAI encoder, whose
every leaf JAX's own bf16 step moves 12-46% of its largest value from the
float32 one (a batch norm's backward cancels most of its input's leading
bits).  Every other leaf is held at 5e-2.  bf16 against float32 after 3
steps: |loss_ce difference| < 0.1, as JAX's own test asks.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.ops import lstm as jlstm
from transformer_clip_eeg_tpu.ops import pallas_block as jpb
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.state import init_train_state as j_init_state
from transformer_clip_eeg_tpu.train.steps import make_train_step as j_make_train_step
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.eval import regression as reg
from transformer_clip_eeg_tpu_torch.models.encoders import SpeechSmallConv
from transformer_clip_eeg_tpu_torch.models.heads import CLIPSimNoLatentProj
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.ops.attention import TransformerEncoderBlock
from transformer_clip_eeg_tpu_torch.ops.layers import Dropout, init_parameters
from transformer_clip_eeg_tpu_torch.train import loop
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer
from transformer_clip_eeg_tpu_torch.train.steps import chunk_train_step, train_step
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

B, T, SP_D = 4, 32, 12
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4, lstm_units=8,
             speech_dim_override=SP_D)
ZOO = {  # as tests/test_torch_port_zoo_training.py and PERF.md §4
    "Z1": dict(eeg_encoder="conformer", speech_encoder="convLSTM", model_arch="clip_sim"),
    "Z2": dict(eeg_encoder="convLSTM", speech_encoder="smallConv", model_arch="clip_mp"),
    "Z3": dict(eeg_encoder="convLSTMnew", speech_encoder="convLSTM", model_arch="clip_kld"),
    "Z4": dict(eeg_encoder="lstm", speech_encoder="lstm", stimulus_features="mel",
               model_arch="no_contrastive_learning"),
    "Z5": dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
               model_arch="clip_kld_latent_proj"),
    "Z6": dict(eeg_encoder="vlaai", speech_encoder="Wav2vecSmallModel", model_arch="clip_sim"),
}
LOSS_TOL = 1e-2
GRAD_TOL = 5e-2
GRAD_FLOOR = 4e-3  # of the largest gradient: one bf16 unit
STATE_TOL = 1e-2
# (case, leaf pattern) -> limit of the leaf's largest value; the error
# measured on the CPU in the comment
ROUNDING_BOUND_LEAVES = {
    "host": {r"eegModel\.final_layer\.bias": 7e-2},  # 5.23e-2
    "device": {r"eegModel\.final_layer\.bias": 7e-2},  # 5.23e-2
    "Z4": {r"eegModel\.eeg_td1\.": 0.65,  # 0.481 (weight), 0.237 (bias)
           r"eegModel\.(batchnorm|eeg_conv1d|eeg_conv2d)": 0.2,  # up to 0.141
           r"speechModel\.(batchnorm_mel|speech_conv)": 0.15},  # up to 0.102
    "Z5": {r"eegModel\.speech_conv1d\.": 0.17},  # 0.125
    "Z6": {r"eegModel\.": 0.7},  # up to 0.507
}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _NoDropout(jl.Dropout):
    """flax's Dropout as the identity (the batch norms still see
    ``deterministic=False``)."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture
def jax_as_on_a_tpu(monkeypatch):
    """JAX's fused block and LSTM through their Pallas kernels (interpret
    mode), the blocks without masks, flax's Dropout off."""
    monkeypatch.setattr(ja, "_pallas_default", lambda: True)
    monkeypatch.setattr(jlstm, "_pallas_lstm_default", lambda: True)
    block = jpb.fused_transformer_block
    monkeypatch.setattr(
        jpb, "fused_transformer_block",
        lambda x, params, seed, drop_p, ffn_drop_p, heads, scale, training, interpret,
        mm_dtype: block(x, params, seed, drop_p, ffn_drop_p, heads, scale, False, interpret,
                        mm_dtype))
    for module in (je, ja, jh):
        monkeypatch.setattr(module, "Dropout", _NoDropout)


def _port_without_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        if isinstance(m, TransformerEncoderBlock):
            m.drop_p = m.forward_drop_p = 0.0


class _CapturingOptimizer:
    """Stands in for the optimizer: keeps the step's gradients."""

    def __init__(self, params):
        self.params, self.step, self.grads = list(params), 0, None

    def apply(self, grads):
        self.grads, self.step = grads, self.step + 1


# the identity update: new params = params + gradients, so JAX's train step
# hands its gradients out through the state it returns
_IDENTITY_TX = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                            lambda u, s, p=None: (u, s))


def _batch(cfg, seed=11):
    rng = np.random.default_rng(seed)
    eeg = rng.standard_normal((B, T, 64)).astype(np.float32)
    speech = (0.5 + rng.standard_normal((B, T, cfg.speech_dimension))).astype(np.float32)
    ids = np.array([3, 1, 7, 12], np.int32)
    return eeg, speech, ids


def _jax_step(jcfg, state, batch, compute_dtype):
    """JAX's train step on ``state``: ``(losses, gradients, state after)``."""
    step = j_make_train_step(jcfg.model_arch, donate=False, compute_dtype=compute_dtype)
    after, losses = step(state, batch, jax.random.PRNGKey(5), warmup=False)
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), after.params,
                         state.params)
    return losses, grads, after


def _port_step(tcfg, variables, batch, path="host", compute_dtype="bfloat16"):
    """The port's train step on JAX's ``variables`` and a numpy ``batch``,
    dropout off: ``(losses, gradients, model after)``.  ``path="device"``
    gathers the batch from a bf16 chunk store (one subject, the batch's
    windows in order)."""
    eeg, speech, ids = batch
    tmodel = build_model_from_config(tcfg, 16, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(variables, tmodel))
    _port_without_dropout(tmodel)
    opt = _CapturingOptimizer(tmodel.parameters())
    step_kw = dict(seed=3, warmup=False, model_arch=tcfg.model_arch,
                   compute_dtype=compute_dtype)
    ids_t = torch.from_numpy(ids.astype(np.int64))
    if path == "host":
        losses = train_step(tmodel, opt, {"eeg": torch.from_numpy(eeg),
                                          "speech": torch.from_numpy(speech), "ids": ids_t},
                            **step_kw)
    else:
        losses = chunk_train_step(
            tmodel, opt, torch.from_numpy(eeg)[None].to(torch.bfloat16),
            torch.from_numpy(speech).to(torch.bfloat16), ids_t, torch.arange(B),
            torch.zeros(B, dtype=torch.int64), **step_kw)
    return losses, opt.grads, tmodel


def _jax_variables(kw):
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    batch = _batch(tcfg)
    jmodel = j_build(jcfg, bank_size=16)
    state = j_init_state(jmodel, jax.random.PRNGKey(0), batch, _IDENTITY_TX)
    return jcfg, tcfg, batch, state


def _bf16_step_pair(kw, path="host"):
    """JAX's bf16 train step and the port's on the same weights and batch:
    ``(jax losses, jax gradients and state after, port losses, port
    gradients, port model after)``, the gradients in torch's layout."""
    jcfg, tcfg, batch, state = _jax_variables(kw)
    eeg, speech, ids = batch
    jlosses, jgrads, after = _jax_step(jcfg, state, {"eeg": eeg, "speech": speech, "ids": ids},
                                       "bfloat16")
    losses, grads, tmodel = _port_step(tcfg, jax.tree.map(np.asarray, state.variables), batch,
                                       path)
    want = state_dict_from_jax({**jax.tree.map(np.asarray, after.variables),
                                "params": jax.tree.map(np.asarray, jgrads)}, tmodel)
    return jlosses, want, losses, grads, tmodel


def _grad_limit(name: str, leaf: str) -> float:
    """The leaf's limit, of its largest value: ``GRAD_TOL``, or its own where
    ``ROUNDING_BOUND_LEAVES`` names it for the case ``name``."""
    for pattern, limit in ROUNDING_BOUND_LEAVES.get(name, {}).items():
        if re.match(pattern, leaf):
            return limit
    return GRAD_TOL


def _hold_step(jlosses, want, losses, grads, tmodel, name):
    assert set(losses) == set(jlosses), name
    assert losses["loss_ce"].dtype == torch.float32
    for k in losses:
        got, ref = float(losses[k]), float(jlosses[k])
        assert abs(got - ref) <= LOSS_TOL * max(abs(ref), 1e-6), (name, k, got, ref)
    names = [n for n, _ in tmodel.named_parameters()]
    top = max(float(want[n].abs().max()) for n in names)
    for n, g in zip(names, grads):
        w = want[n]
        scale = max(float(w.abs().max()), GRAD_FLOOR * top)
        err = float((g - w).abs().max()) / scale
        assert err <= _grad_limit(name, n), (name, n, err)
    for n, buf in tmodel.named_buffers():
        assert buf.dtype == torch.float32, n
        w = want[n]
        err = float((buf - w).abs().max()) / max(1.0, float(w.abs().max()))
        assert err <= STATE_TOL, (name, n, err)


@pytest.mark.parametrize("path", ["host", "device"])
def test_flagship_bf16_step_matches_the_jax_train_step(path, jax_as_on_a_tpu):
    """The flagship at depth 2: losses (loss_ce in float32), every gradient,
    the bank after its update against JAX's bf16 step; the device path on a
    bf16 store takes the same step as the host path."""
    _hold_step(*_bf16_step_pair(SMALL, path), name=path)


def test_device_and_host_paths_take_the_same_bf16_step():
    """A bf16 chunk store rounds what the bf16 step rounds anyway: the two
    paths' losses and gradients are equal."""
    _, tcfg, batch, state = _jax_variables(SMALL)
    before = jax.tree.map(np.asarray, state.variables)
    l_host, g_host, _ = _port_step(tcfg, before, batch, "host")
    l_dev, g_dev, _ = _port_step(tcfg, before, batch, "device")
    assert all(torch.equal(l_host[k], l_dev[k]) for k in l_host)
    assert all(torch.equal(a, b) for a, b in zip(g_host, g_dev))


@pytest.mark.parametrize("z", sorted(ZOO))
def test_one_bf16_step_per_zoo_configuration_matches_jax(z, jax_as_on_a_tpu):
    """Each zoo configuration at a small width: one bf16 train step against
    JAX's, running statistics included (Z4, Z5)."""
    kw = dict(SMALL, lambda_sim_loss=0.5, **ZOO[z])
    if kw.get("stimulus_features") == "mel":
        del kw["speech_dim_override"]
    _hold_step(*_bf16_step_pair(kw), name=z)


def _tiny_model():
    eeg = SpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                          speech_dim=64, time_dimension=32)
    speech = SpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                             speech_dim=8, time_dimension=32)
    model = CLIPSimNoLatentProj(eeg, speech, bank_size=64, latent_dim=4 * 32,
                                temperature=0.075, window_length=32)
    init_parameters(model, torch.Generator().manual_seed(0))
    return model


def test_bf16_steps_stay_close_to_f32():
    """The port's counterpart of JAX's ``test_bf16_step_close_to_f32``: three
    AdamW steps of the same model and batch in float32 and in bf16; loss_ce
    stays float32 and within 0.1."""
    rng = np.random.default_rng(0)
    batch = {"eeg": torch.from_numpy(rng.standard_normal((16, 32, 64)).astype(np.float32)),
             "speech": torch.from_numpy(rng.standard_normal((16, 32, 8)).astype(np.float32)),
             "ids": torch.arange(1, 17)}
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = _tiny_model()
        opt = make_optimizer(model.parameters(), "adamw", 1e-3)
        for _ in range(3):
            out = train_step(model, opt, batch, seed=7, warmup=False, compute_dtype=dtype)
        assert out["loss_ce"].dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in model.parameters())
        losses[dtype] = float(out["loss_ce"])
    assert np.isfinite(losses["bfloat16"])
    assert abs(losses["bfloat16"] - losses["float32"]) < 0.1


def test_cli_trains_in_bf16_and_validates_in_f32(tmp_path, monkeypatch):
    """``cli.main --compute_dtype bfloat16`` on the CPU: the train steps see
    bf16 batches, the validation steps float32 ones; ``args.txt`` keeps the
    mode; the evaluation suite runs; ``--only_evaluate`` reloads the run."""
    seq = reg.train_regression_probes_batched
    monkeypatch.setattr(reg, "train_regression_probes_batched",
                        lambda *a, **k: seq(*a, **{**k, "epochs": 3}))
    seen = {"train": set(), "eval": set()}
    real_train, real_eval = loop.train_step, loop.eval_step

    def spy_train(model, optimizer, batch, *a, **k):
        out = real_train(model, optimizer, batch, *a, **k)
        seen["train"].add(k.get("compute_dtype"))
        return out

    def spy_eval(model, batch, *a, **k):
        seen["eval"].add(batch["eeg"].dtype)
        model_dtypes = {p.dtype for p in model.parameters()}
        assert model_dtypes == {torch.float32}
        return real_eval(model, batch, *a, **k)

    monkeypatch.setattr(loop, "train_step", spy_train)
    monkeypatch.setattr(loop, "eval_step", spy_eval)
    root, results = str(tmp_path / "data"), str(tmp_path / "results")
    make_fixture(root, n_stories=3, n_subjects=2, story_seconds=45, speech_dim=8)
    rc = cli.main(["--data_dir", root, "--results_folder", results, "--run", "0", "--epochs",
                   "1", "--batch_size", "4", "--attention_depth", "1", "--latent_dim", "4",
                   "--lstm_units", "8", "--speech_dim_override", "8",
                   "--number_of_training_subjects", "2", "--compute_dtype", "bfloat16"],
                  device="cpu")
    assert rc == 0
    assert seen == {"train": {"bfloat16"}, "eval": {torch.float32}}
    (run,) = os.listdir(results)
    rd = os.path.join(results, run)
    assert TrainConfig.load(os.path.join(rd, "args.txt")).compute_dtype == "bfloat16"
    names = set(os.listdir(rd))
    assert {"loss.txt", "evaluation_challenge_set_2023_mm.json",
            "evaluation_regression.json"} <= names
    assert "error_regression.txt" not in names
    with open(os.path.join(rd, "loss.txt")) as fh:
        log = fh.read()
    assert "training done" in log and "nan" not in log
    assert cli.main(["--only_evaluate", "yes", "--results_folder", rd], device="cpu") == 0
