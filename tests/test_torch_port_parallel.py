"""Torch port, data-parallel training (``--n_data_shards``, ``parallel/``) on
two gloo CPU ranks against JAX's sharded step and the port's one-process
step.

One pair of ranks (``parallel.launch``, a file store under ``tmp_path``)
runs every case of ``tests/torch_port_parallel_ranks.py`` once; the tests
read what each rank saved:

* JAX ``tests/test_multihost.py``'s global InfoNCE statistic;
* JAX ``tests/test_parallel.py``'s tiny model on carried weights, 3 steps,
  against JAX's ``make_mesh(2)`` sharded step at JAX's limits;
* the flagship at a small width and depth 2 with dropout, an augmentation and
  ``--addEEG`` mixup on, unfused and with its conv blocks fused: every
  gradient before AdamW against the one-process step (in float64, as each
  case of that test: in float32 the ranks' split sums alone move a
  gradient that cancels, such as a bias's, by up to 1.7e-6 of its largest
  value, so float32 cannot resolve the 1e-6 limit);
* the lstm encoders' batch norms (zoo cell Z4) against JAX's mesh step and
  the port's one-process step;
* the replicas and banks of the two ranks bit for bit.

A group of one against no group, bit for bit, runs in the test process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_port_parallel_ranks as ranks
from transformer_clip_eeg_tpu.models import encoders as je
from transformer_clip_eeg_tpu.models import heads as jh
from transformer_clip_eeg_tpu.models.encoders import SpeechSmallConv as JSpeechSmallConv
from transformer_clip_eeg_tpu.models.heads import CLIPSimNoLatentProj as JCLIPSimNoLatentProj
from transformer_clip_eeg_tpu.ops import attention as ja
from transformer_clip_eeg_tpu.ops import layers as jl
from transformer_clip_eeg_tpu.parallel import make_mesh as j_make_mesh
from transformer_clip_eeg_tpu.parallel import replicate as j_replicate
from transformer_clip_eeg_tpu.parallel import shard_batch as j_shard_batch
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu.train.state import TrainState
from transformer_clip_eeg_tpu.train.state import make_optimizer as j_make_optimizer
from transformer_clip_eeg_tpu.train.steps import make_train_step
from transformer_clip_eeg_tpu_torch.ops import augment as aug
from transformer_clip_eeg_tpu_torch.ops.dropout import dropout_mask
from transformer_clip_eeg_tpu_torch.ops.fused_block import DropoutConfig, block_masks, shard_seed
from transformer_clip_eeg_tpu_torch.ops.fused_conv import conv_mask
from transformer_clip_eeg_tpu_torch.parallel import Mesh, launch, make_mesh, shard_batch
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

N = 2
JAX_LOSS_RTOL = 2e-5  # JAX tests/test_parallel.py's limits
JAX_STATE_ATOL = 2e-5
GRAD_TOL = 1e-6  # of each leaf's largest value: the 2-rank step against 1 process (float64)
STATS_TOL = 1e-6  # batch norms' running statistics, 2 ranks against 1 process
T, SP_D = 32, 16
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4, speech_dim_override=SP_D)
Z4 = dict(window_length_s=1, fs=T, latent_dim=4, lstm_units=8, eeg_encoder="lstm",
          speech_encoder="lstm", stimulus_features="mel", model_arch="no_contrastive_learning")


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """This process steps on as few threads as each rank: the suite runs
    test files side by side, and a rank's default of one thread a core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    yield
    torch.set_num_threads(n)


class _NoDropout(jl.Dropout):
    """flax's Dropout as the identity (its masks cannot be drawn in torch;
    the batch norms need ``deterministic=False``)."""

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


def _jax_tiny_model():
    eeg = JSpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                           speech_dim=64, time_dimension=32)
    speech = JSpeechSmallConv(output_dim=4, kernel_size_temporal=8, dropout_rate=0.0,
                              speech_dim=8, time_dimension=32)
    return JCLIPSimNoLatentProj(eegModel=eeg, speechModel=speech, bank_size=64,
                                latent_dim=speech.get_output_dim(32), temperature=0.075,
                                window_length=32)


def _tiny_batch(rng, bs=16):
    return {"eeg": rng.standard_normal((bs, 32, 64)).astype(np.float32),
            "speech": rng.standard_normal((bs, 32, 8)).astype(np.float32),
            "ids": rng.choice(64, bs, replace=False).astype(np.int32) + 1}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "ids" else v)
            for k, v in batch.items()}


def _jax_mesh_steps(jmodel, variables, batches, model_arch):
    """JAX's train step (adamw 1e-3) on ``make_mesh(2)``: the state
    replicated, each batch sharded over 'data'.  Returns the losses and the
    final variables."""
    tx = j_make_optimizer("adamw", 1e-3)
    state = TrainState.create(apply_fn=jmodel.apply, variables=jax.tree.map(
        jnp.asarray, variables), tx=tx)
    mesh = j_make_mesh(N)
    state = j_replicate(mesh, state)
    step = make_train_step(model_arch, donate=False)
    losses = []
    for b in batches:
        state, out = step(state, j_shard_batch(mesh, b), jax.random.PRNGKey(7), warmup=False)
        losses.append({k: float(v) for k, v in out.items()})
    return losses, jax.tree.map(np.asarray, jax.device_get(state.variables))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The cases the ranks run, and JAX's results for those that have one."""
    rng = np.random.default_rng(0)
    jmodel = _jax_tiny_model()
    batches = [_tiny_batch(rng) for _ in range(3)]
    b0 = batches[0]
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b0["eeg"], b0["speech"], b0["ids"], deterministic=True)))
    jax_tiny = _jax_mesh_steps(jmodel, variables, batches, "clip_sim_no_latent_proj")
    tiny = {"model": "tiny", "state": state_dict_from_jax(variables, ranks.tiny_model()),
            "batches": [_torch_batch(b) for b in batches]}

    bs = 16
    eeg = rng.standard_normal((bs, T, 64)).astype(np.float32)
    flagship_batch = _torch_batch({
        "eeg": eeg, "speech": rng.standard_normal((bs, T, SP_D)).astype(np.float32),
        "ids": rng.choice(64, bs, replace=False).astype(np.int32) + 1,
        "partner_eeg": rng.standard_normal((bs, T, 64)).astype(np.float32)})
    step = dict(augmentations=("GaussianNoise",), augmentation_probability=0.5, add_eeg=True)
    flagship = {"model": "config", "config": SMALL, "bank_size": 64,
                "batches": [flagship_batch], "step": step}
    fused = dict(flagship, fused=True, step=dict(step, augmentations=("ChannelsShuffle",)))

    with pytest.MonkeyPatch.context() as mp:
        for module in (je, ja, jh):
            mp.setattr(module, "Dropout", _NoDropout)
        jcfg = JConfig(**Z4)
        jz4 = j_build(jcfg, bank_size=16)
        zb = [{"eeg": rng.standard_normal((8, T, 64)).astype(np.float32),
               "speech": (1.5 + rng.standard_normal((8, T, 28))).astype(np.float32),
               "ids": rng.choice(16, 8, replace=False).astype(np.int32) + 1} for _ in range(2)]
        zvars = jax.tree.map(np.asarray, dict(jz4.init(
            {"params": jax.random.PRNGKey(0)}, zb[0]["eeg"], zb[0]["speech"], zb[0]["ids"])))
        jax_z4 = _jax_mesh_steps(jz4, zvars, zb, jcfg.model_arch)
    z4_template = ranks.build_case_model({"model": "config", "config": Z4, "bank_size": 16})
    z4 = {"model": "config", "config": Z4, "bank_size": 16, "no_dropout": True,
          "state": state_dict_from_jax(zvars, z4_template),
          "batches": [_torch_batch(b) for b in zb], "step": dict(model_arch=Z4["model_arch"])}

    path = str(tmp_path_factory.mktemp("parallel") / "cases.pt")
    all_cases = {"tiny": tiny, "z4": z4}
    for name, case in (("tiny", tiny), ("flagship", flagship), ("fused", fused), ("z4", z4)):
        all_cases[name + "_f64"] = dict(case, dtype=torch.float64)
    torch.save(all_cases, path)
    return path, all_cases, {"tiny": jax_tiny, "z4": jax_z4}


@pytest.fixture(scope="module")
def rank_results(cases):
    """What each of the two ranks computed, from one launch."""
    path, _, _ = cases
    assert launch(N, ranks.step_job, (path,), device="cpu") == 0
    return [torch.load(os.path.join(os.path.dirname(path), f"rank{r}.pt"), weights_only=False)
            for r in range(N)]


@pytest.fixture(scope="module")
def one_process(cases):
    """The same cases in this process, without a mesh."""
    _, all_cases, _ = cases
    return {name: ranks.run_case(case) for name, case in all_cases.items()}


def _leaf_errors(got, want):
    """Each leaf's max error over its largest value, floored at 1e-6 of the
    largest gradient of all: some leaves' true gradient is 0 (the keys'
    biases, which shift every logit of a query alike), and theirs is
    rounding."""
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    return [float((g - w).abs().max()) / max(float(w.abs().max()), floor)
            for g, w in zip(got, want)]


# -- the mesh object and its refusals ---------------------------------------------


def test_mesh_rows_and_shard_batch():
    meshes = [Mesh(N, r, torch.device("cpu"), "gloo", N) for r in range(N)]
    assert [m.rows(16) for m in meshes] == [slice(0, 8), slice(8, 16)]
    assert meshes[0].is_writer and not meshes[1].is_writer
    batch = {"eeg": np.arange(32).reshape(16, 2), "ids": torch.arange(16)}
    parts = [shard_batch(m, batch) for m in meshes]
    np.testing.assert_array_equal(np.concatenate([p["eeg"] for p in parts]), batch["eeg"])
    assert torch.equal(torch.cat([p["ids"] for p in parts]), batch["ids"])


def test_refusals():
    """A batch that does not divide over the ranks, an axis of no ranks, a
    mesh without a group (a ``'model'`` axis too: the extraction's tensor
    parallelism, ``tests/test_torch_port_wav2vec2_tp.py``), and shards whose
    dropout tiles differ from the global batch's."""
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(N, 0, torch.device("cpu"), "gloo").rows(7)
    with pytest.raises(ValueError, match="both axes need at least one rank"):
        make_mesh(N, n_model=0, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed group"):
        make_mesh(N, n_model=2, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed group"):
        make_mesh(N, device="cpu")
    assert shard_seed(5, 8, 8, 16) == 6  # tiles of 8: the second tile's seed
    assert shard_seed(5, 16) == 5
    with pytest.raises(ValueError, match="batch tile"):
        shard_seed(5, 4, 4, 8)  # the shard's tile is 4, the batch's 8


def _block(seed, b, t=6):
    return block_masks(b, t, 4, 8, 2, DropoutConfig(True, seed, 0.5, 0.5))


def _two_halves(draw):
    """``draw(rows, row_offset, global_batch)`` for the whole batch of 16 and
    for each half as a rank draws it, the halves stacked."""
    whole = draw(16, 0, None)
    halves = [draw(8, r * 8, 16) for r in range(N)]
    return whole, halves


ROW_DRAWS = {
    "dropout": lambda b, r0, _: dropout_mask(11, (b, 5, 3), 0.3, offset=r0 * 15),
    "block_masks": lambda b, r0, g: _block(shard_seed(21, b, r0, g), b),
    "conv_mask": lambda b, r0, g: conv_mask(shard_seed(31, b, r0, g), b, 6, 4, 0.2),
    "mixup": lambda b, r0, _: aug.draw_batch_mixup(41, b, 0.5, "cpu", r0),
    **{name: (lambda b, r0, _, name=name: aug.DRAWS[name](
        51, torch.zeros(b, 64, 20), 0.5, row0=r0, **aug.BEST_AUG_PARAMS.get(name, {})))
       for name in aug.DRAWS},
}


@pytest.mark.parametrize("name", sorted(ROW_DRAWS))
def test_a_ranks_draws_are_its_rows_of_the_global_batchs(name):
    """Every per-row random draw of the step (dropout masks, #1/#2 and #5/#6's
    masks through the seed shift, mixup, each augmentation) on a rank's rows
    equals those rows of the one-process draw, bit for bit."""
    whole, halves = _two_halves(ROW_DRAWS[name])

    def leaves(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in leaves(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for e in x for v in leaves(e)]
        return [] if x is None else [x]

    want = leaves(whole)
    got = [torch.cat(parts) for parts in zip(*(leaves(h) for h in halves))]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- two ranks ----------------------------------------------------------------------


def test_global_infonce_statistic(rank_results):
    """JAX tests/test_multihost.py's statistic over the gathered rows: the same
    on both ranks, and the one of the whole batch."""
    full = np.arange(64, dtype=np.float64).reshape(16, 4) + 1.0
    xn = full / np.linalg.norm(full, axis=1, keepdims=True)
    for res in rank_results:
        np.testing.assert_allclose(res["infonce"], (xn @ xn.T).sum(), rtol=1e-6)
    assert rank_results[0]["infonce"] == rank_results[1]["infonce"]


def test_tiny_model_matches_jax_sharded_step(cases, rank_results):
    """JAX tests/test_parallel.py on carried weights: 3 steps, losses at rtol
    2e-5, parameters and bank at atol 2e-5."""
    _, _, jax_ref = cases
    jlosses, jvars = jax_ref["tiny"]
    want = state_dict_from_jax(jvars, ranks.tiny_model())
    for res in rank_results:
        got = res["cases"]["tiny"]
        for mine, theirs in zip(got["losses"], jlosses):
            np.testing.assert_allclose(mine["loss_ce"], theirs["loss_ce"], rtol=JAX_LOSS_RTOL)
            np.testing.assert_allclose(mine["loss_total"], theirs["loss_total"],
                                       rtol=JAX_LOSS_RTOL)
        for k, w in want.items():
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), atol=JAX_STATE_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["tiny_f64", "flagship_f64", "fused_f64", "z4_f64"])
def test_gradients_before_adamw_match_one_process(name, rank_results, one_process):
    """Every gradient the optimizer is handed (the ranks' mean) within 1e-6 of
    its leaf's largest value of the one-process step's, for the encoders'
    leaves (partial on each rank) and the heads' (the temperatures, complete
    on each rank) alike; the flagship with dropout, an augmentation and
    mixup on, its conv blocks unfused and fused; the losses too."""
    want = one_process[name]
    for res in rank_results:
        got = res["cases"][name]
        assert got["names"] == want["names"]
        assert name == "z4_f64" or "temperature" in got["names"]  # a head leaf
        for gs, ws in zip(got["grads"], want["grads"]):
            errs = _leaf_errors(gs, ws)
            worst = int(np.argmax(errs))
            assert errs[worst] <= GRAD_TOL, (got["names"][worst], errs[worst])
        for mine, theirs in zip(got["losses"], want["losses"]):
            for k in theirs:
                np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["tiny", "z4", "flagship_f64", "fused_f64"])
def test_replicas_and_banks_identical_across_ranks(name, rank_results, one_process):
    """Both ranks end with the same parameters, bank and running statistics,
    bit for bit (and the same checksum); the bank within 1e-6 of the
    one-process step's."""
    a, b = (res["cases"][name] for res in rank_results)
    assert a["checksum"] == b["checksum"]
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    bank = [k for k in a["state"] if k.endswith("eegMemoryBank.memory")]
    for k in bank:
        np.testing.assert_allclose(a["state"][k].numpy(), one_process[name]["state"][k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_lstm_batch_norms_take_global_statistics(cases, rank_results, one_process):
    """Z4 (the lstm encoders' batch norms): the running statistics after 2
    steps against JAX's mesh step (its parameters at JAX's limit) and within
    1e-6 of the port's one-process step."""
    _, _, jax_ref = cases
    jlosses, jvars = jax_ref["z4"]
    template = ranks.build_case_model({"model": "config", "config": Z4, "bank_size": 16})
    want = state_dict_from_jax(jvars, template)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 4
    for res in rank_results:
        got = res["cases"]["z4"]
        for mine, theirs in zip(got["losses"], jlosses):
            np.testing.assert_allclose(mine["loss_ce"], theirs["loss_ce"], rtol=JAX_LOSS_RTOL)
        for k, w in want.items():
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), atol=JAX_STATE_ATOL,
                                       err_msg=k)
        for k in stats:
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       one_process["z4"]["state"][k].numpy(), atol=STATS_TOL,
                                       err_msg=k)


def test_one_rank_equals_no_group_bit_for_bit(cases):
    """``--n_data_shards 1``: a group of one (in this process) steps exactly
    as no group does, every loss, gradient and state tensor."""
    path, all_cases, _ = cases
    small = {k: all_cases[k] for k in ("flagship_f64", "z4")}
    one_path = os.path.join(os.path.dirname(path), "one_rank_cases.pt")
    torch.save(small, one_path)
    assert launch(1, ranks.single_rank_job, (one_path,), device="cpu") == 0
    out = torch.load(os.path.join(os.path.dirname(path), "n1.pt"), weights_only=False)
    for name, (meshed, plain) in out.items():
        assert meshed["losses"] == plain["losses"], name
        for gs, ws in zip(meshed["grads"], plain["grads"]):
            assert all(torch.equal(g, w) for g, w in zip(gs, ws)), name
        for k in plain["state"]:
            assert torch.equal(meshed["state"][k], plain["state"][k]), (name, k)
