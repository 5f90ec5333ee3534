"""Torch port, the tensor-parallel wav2vec2 extraction (``parallel/tp.py``,
the ``Attention`` / ``FeedForward`` forwards with a ``tp_group``,
``Wav2Vec2FeatureExtractor(mesh=)``, the extraction CLI's
``--n_data_shards`` / ``--n_model_shards``) on gloo CPU ranks, against JAX
``tests/test_wav2vec2_tp.py`` on its tiny config (hidden 32, 3 layers, 4
heads, FFN 64, 800 Hz audio at 16 frames/s).

Each grid of ranks (1 x 2, 2 x 1 and 2 x 2) is launched once
(``tp_job`` of ``tests/torch_port_parallel_ranks.py``): taps 2 and 3 of 13 s
of audio against the port's one-process extractor and JAX's extractor on the
same ``make_mesh`` grid, at JAX's limit (atol 2e-5).  Then the layout
against ``wav2vec2_tp_specs``, ``validate_tp``, the slices, and the CLI with
``--n_data_shards 1 --n_model_shards 2`` (which spawns its ranks) against
the one-process CLI.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Config as JConfig
from transformer_clip_eeg_tpu.models.wav2vec2 import Wav2Vec2Model as JModel
from transformer_clip_eeg_tpu.parallel import make_mesh as j_make_mesh
from transformer_clip_eeg_tpu.parallel import wav2vec2_tp_specs
from transformer_clip_eeg_tpu.preprocess.wav2vec import (
    Wav2Vec2FeatureExtractor as JExtractor,
)
from transformer_clip_eeg_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    wav2vec2_state_dict_from_jax,
)
from transformer_clip_eeg_tpu_torch.parallel import (
    launch,
    shard_wav2vec2_state_dict,
    validate_tp,
    wav2vec2_tp_layout,
)
from transformer_clip_eeg_tpu_torch.preprocess import wav2vec as w

SR, FRAMES_PER_S = 800, 16  # JAX's test: total stride 50
TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_stride=(5, 10), conv_kernel=(10, 12),
            num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4)
TAPS = [2, 3]
ATOL = 2e-5  # JAX tests/test_wav2vec2_tp.py:102-104
GRIDS = [(1, 2), (2, 1), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's tiny model and weights, the port's state_dict of them, 13 s of
    audio, and the case file the ranks read."""
    jmodel = JModel(JConfig(**TINY))
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(0),
                                                           np.zeros((1, SR), np.float32))))
    audio = np.random.default_rng(7).standard_normal(SR * 13).astype(np.float32) * 0.1
    case = {"config": Wav2Vec2Config(**TINY), "state": wav2vec2_state_dict_from_jax(variables),
            "audio": audio, "layers": TAPS, "sr": SR, "frames_per_s": FRAMES_PER_S,
            "segment": 4}
    path = str(tmp_path_factory.mktemp("tp") / "case.pt")
    torch.save(case, path)
    return jmodel, variables, case, path


@pytest.fixture(scope="module")
def one_process(tiny):
    return ranks.tp_extraction(tiny[2])


@pytest.fixture(scope="module", params=GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def grid_run(request, tiny):
    """One launch of the grid's ranks; what each saved."""
    n_data, n_model = request.param
    path = tiny[3]
    assert launch(n_data * n_model, ranks.tp_job, (path,), device="cpu", n_model=n_model) == 0
    outs = [torch.load(os.path.join(os.path.dirname(path),
                                    f"tp_{n_data}x{n_model}_rank{r}.pt"), weights_only=False)
            for r in range(n_data * n_model)]
    return request.param, outs


def test_grid_matches_one_process(grid_run, one_process):
    """13 s in segments of 4 s: 3 full chunks (padded to a multiple of the
    data axis) and the ragged tail; every rank returns the whole taps, at
    ``(r // n_model, r % n_model)``, within 2e-5 of the one-process
    extractor."""
    (n_data, n_model), outs = grid_run
    assert [o["grid"] for o in outs] == [(r // n_model, r % n_model)
                                         for r in range(n_data * n_model)]
    for o in outs:
        for layer in TAPS:
            got, want = o["taps"][layer], one_process[layer]
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_grid_matches_jax_on_the_same_grid(grid_run, tiny):
    """JAX's extractor on ``make_mesh(n_data, n_model)`` (its Megatron
    placement, GSPMD's all-reduces), within 2e-5."""
    (n_data, n_model), outs = grid_run
    jmodel, variables, case, _ = tiny
    jext = JExtractor(jmodel, variables, TAPS, sr=SR, frames_per_s=FRAMES_PER_S,
                      mesh=j_make_mesh(n_data=n_data, n_model=n_model))
    want = jext.get_hidden_output(case["audio"], overlap=2, segment_length=4)
    for layer in TAPS:
        np.testing.assert_allclose(outs[0]["taps"][layer], np.asarray(want[layer]), rtol=0,
                                   atol=ATOL)


def test_layout_is_jaxs_megatron_specs(tiny):
    """Every parameter's layout against ``wav2vec2_tp_specs``: each JAX leaf
    filled with its own number, converted, names the port parameter it
    becomes; column-sharded (``P(None, 'model')`` kernels and ``P('model')``
    biases) is ``'column'``, ``P('model', None)`` is ``'row'``, ``P()`` is
    ``'replicated'``."""
    _, variables, case, _ = tiny
    P = jax.sharding.PartitionSpec
    flat, treedef = jax.tree.flatten_with_path(variables)
    numbered = jax.tree.unflatten(treedef, [np.full(np.shape(leaf), i + 1, np.float32)
                                            for i, (_, leaf) in enumerate(flat)])
    specs = jax.tree.leaves(wav2vec2_tp_specs(variables), is_leaf=lambda x: isinstance(x, P))
    want_of = {P(None, "model"): "column", P("model"): "column", P("model", None): "row",
               P(): "replicated"}
    layout = wav2vec2_tp_layout(case["state"])
    assert len(layout) == len(flat) == len(specs)
    for name, t in wav2vec2_state_dict_from_jax(numbered).items():
        leaf = int(t.reshape(-1)[0]) - 1
        assert layout[name] == want_of[specs[leaf]], (name, flat[leaf][0], specs[leaf])
    assert layout["encoder.layers.0.attention.q_proj.weight"] == "column"
    assert layout["encoder.layers.0.attention.out_proj.bias"] == "replicated"
    assert layout["encoder.layers.2.feed_forward.output_dense.weight"] == "row"


def test_validate_tp_rejects_a_misaligned_degree(tiny):
    """JAX's checks and texts: 4 heads and FFN 64 take 2, not 3; FFN 66 not 4."""
    validate_tp(Wav2Vec2Config(**TINY), 2)
    with pytest.raises(ValueError, match="TP degree 3 must divide num_attention_heads 4"):
        validate_tp(Wav2Vec2Config(**TINY), 3)
    with pytest.raises(ValueError, match="TP degree 4 must divide intermediate_size 66"):
        validate_tp(Wav2Vec2Config(**{**TINY, "intermediate_size": 66}), 4)


def test_slices_rebuild_the_whole_weights(tiny):
    """Each rank's slices of 2 (the weight's rows for a column-sharded
    product, with its bias; the columns for a row-sharded one; the rest
    whole) put back together are the whole state_dict, and a TP model holds
    2 of the 4 heads and 32 of the 64 FFN units."""
    case = tiny[2]
    parts = [shard_wav2vec2_state_dict(case["state"], 2, r) for r in (0, 1)]
    layout = wav2vec2_tp_layout(case["state"])
    for name, whole in case["state"].items():
        a, b = parts[0][name], parts[1][name]
        if layout[name] == "replicated":
            assert a is whole and b is whole
        else:
            dim = 0 if layout[name] == "column" else 1
            assert a.shape[dim] * 2 == whole.shape[dim]
            assert torch.equal(torch.cat([a, b], dim), whole)
    q = parts[0]["encoder.layers.0.attention.q_proj.weight"]
    assert q.shape == (16, 32)
    assert parts[0]["encoder.layers.0.feed_forward.output_dense.weight"].shape == (32, 32)


def test_single_rank_forward_unchanged(tiny, one_process):
    """No group: the model built without one is the single-device forward
    (``Attention`` / ``FeedForward`` with ``tp_group=None``), bit for bit
    through ``Wav2Vec2Model.hidden_states``."""
    case = tiny[2]
    model = Wav2Vec2Model(case["config"], tp_group=None)
    model.load_state_dict(case["state"])
    out = w.Wav2Vec2FeatureExtractor(model.eval(), TAPS, sr=SR, frames_per_s=FRAMES_PER_S
                                     ).get_hidden_output(case["audio"], 2, 4)
    for layer in TAPS:
        np.testing.assert_array_equal(out[layer], one_process[layer])


# -- the command line ------------------------------------------------------------


def _hf_directory(d: str) -> None:
    """An HF checkpoint directory at 16 kHz (XLSR-53's strides at narrow
    widths: 4 heads, FFN 32), written without ``transformers``:
    ``config.json`` and ``pytorch_model.bin`` with the ``wav2vec2.`` prefix."""
    cfg = Wav2Vec2Config(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=32,
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    model = Wav2Vec2Model(cfg)
    model.init_random(torch.Generator().manual_seed(3))
    os.makedirs(d)
    torch.save({f"wav2vec2.{k}": v for k, v in model.state_dict().items()},
               os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f)


def _tree(root: str) -> None:
    stim = os.path.join(root, "stimuli", "eeg")
    os.makedirs(stim)
    raw = os.path.join(root, "audiobook_1.npz")
    audio = (0.1 * np.random.default_rng(4).standard_normal(int(48000 * 9.3)))
    np.savez(raw, audio=audio.astype(np.float32), fs=48000)
    with open(raw, "rb") as f_in, gzip.open(os.path.join(stim, "audiobook_1.npz.gz"),
                                            "wb") as f_out:
        f_out.write(f_in.read())


def _saved(root):
    d = os.path.join(root, "derivatives", "preprocessed_stimuli")
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_main_n_model_shards_writes_the_one_process_files(tmp_path, monkeypatch):
    """``main --n_data_shards 1 --n_model_shards 2`` spawns a 1 x 2 mesh;
    rank 0 alone writes ``audiobook_1_-_wav2vec_{1,2}.npy``, each within
    2e-5 of the one-process CLI's file; a second sharded run skips the
    story."""
    model_dir = str(tmp_path / "model")
    _hf_directory(model_dir)
    roots = {name: str(tmp_path / name) for name in ("one", "tp")}
    for root in roots.values():
        _tree(root)
    argv = ["--model_path", model_dir, "--layers", "1", "2"]
    assert w.main(["--dataset_root", roots["one"], *argv], device="cpu") == 0
    monkeypatch.setenv("OMP_NUM_THREADS", str(ranks.THREADS))
    tp_argv = ["--dataset_root", roots["tp"], *argv, "--n_data_shards", "1",
               "--n_model_shards", "2"]
    assert w.main(tp_argv, device="cpu") == 0
    want, got = _saved(roots["one"]), _saved(roots["tp"])
    assert list(got) == list(want) == ["audiobook_1_-_wav2vec_1.npy",
                                       "audiobook_1_-_wav2vec_2.npy"]
    for name in want:
        assert got[name].shape == want[name].shape and got[name].shape[1] == 16
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL, err_msg=name)
    before = {n: os.path.getmtime(os.path.join(roots["tp"], "derivatives",
                                               "preprocessed_stimuli", n)) for n in got}
    assert w.main(tp_argv, device="cpu") == 0
    assert before == {n: os.path.getmtime(os.path.join(roots["tp"], "derivatives",
                                                       "preprocessed_stimuli", n)) for n in got}
