"""Torch port, sharded serving (``serve --shard N``) on two gloo CPU ranks.

One pair of ranks (``parallel.launch``) runs ``serve_job`` of
``tests/torch_port_parallel_ranks.py`` once: the flagship at a small width
on weights carried from JAX (``InferenceSession(mesh=)``, rank 1 handed
other weights that rank 0's broadcast replaces) and the row-sharded
``RetrievalIndex(mesh=)``.  The tests hold them against the port's
one-process session and index (JAX ``tests/test_serve.py:136-186``: 1e-6,
equal indices) and against JAX's sharded session and index on
``make_mesh(2)``; the index's ties against ``lax.top_k``'s order; then
``serve.main --shard 2`` (which spawns its ranks) against no ``--shard``,
and ``--shard 1`` bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks
from transformer_clip_eeg_tpu.parallel import make_mesh as j_make_mesh
from transformer_clip_eeg_tpu.serve import InferenceSession as JSession
from transformer_clip_eeg_tpu.serve import RetrievalIndex as JIndex
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch import serve
from transformer_clip_eeg_tpu_torch.parallel import Mesh, launch
from transformer_clip_eeg_tpu_torch.serve import InferenceSession, RetrievalIndex
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train.state import Optimizer
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

N = 2
T, EEG_C, SP_D, CHUNK, BANK = 32, 64, 8, 4, 16
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4, speech_dim_override=SP_D)
# JAX tests/test_serve.py:151-156 (sharded against one device); the port's
# sharded session against JAX's is held there too (4.9e-7 at most on this
# model, from the f32 sums in another order)
TOL = 1e-6
N_WINDOWS = 11  # JAX's test: a ragged last chunk


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(ranks.THREADS)
    yield
    torch.set_num_threads(n)


def _unit_rows(rng, n, d=6):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index_cases():
    """JAX ``tests/test_serve.py``'s sharded-index case on 2 ranks (21 rows,
    capacity 21 → 22, k=4, a row added after the build, k=23) and a bank with
    duplicated rows whose ties span one rank and both."""
    rng = np.random.default_rng(8)
    bank = _unit_rows(rng, 21)
    q = rng.standard_normal((3, 6)).astype(np.float32)
    extra = rng.standard_normal((1, 6)).astype(np.float32)
    # multiples of 1/8: every score is exact in float32, whatever order a
    # product sums in, so equal rows tie exactly
    ties = rng.integers(-3, 4, (20, 6)).astype(np.float32) / 8
    ties[2] = 0.5
    ties[11] = [0.5, -0.5] * 3
    ties[5] = ties[15] = ties[2]  # rank 0 holds rows 0-9, rank 1 rows 10-19
    ties[17] = ties[11]
    tq = np.stack([ties[2], ties[11], ties[2] + ties[11]])
    return {"jax": {"bank": bank, "capacity": 21, "queries": q,
                    "ops": [("topk", 4), ("add", extra), ("topk", 23)]},
            "ties": {"bank": ties, "capacity": 20, "queries": tq,
                     "ops": [("topk", 5), ("topk", 20)]}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The carried weights, the windows, JAX's sharded session's embeddings
    and the index cases, saved for the ranks."""
    jmodel = j_build(JConfig(**SMALL), bank_size=BANK)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), rng.standard_normal((2, T, EEG_C)).astype(np.float32),
        rng.standard_normal((2, T, SP_D)).astype(np.float32), np.arange(1, 3, dtype=np.int32))))
    template = ranks.build_case_model({"model": "config", "config": SMALL, "bank_size": BANK})
    rng = np.random.default_rng(7)
    c = {"config": SMALL, "bank_size": BANK, "chunk": CHUNK,
         "state": state_dict_from_jax(variables, template),
         "eeg": rng.standard_normal((N_WINDOWS, T, EEG_C)).astype(np.float32),
         "speech": rng.standard_normal((N_WINDOWS, T, SP_D)).astype(np.float32),
         "index": _index_cases()}
    jsess = JSession(jmodel, variables, chunk=CHUNK, mesh=j_make_mesh(N))
    jax_emb = {"eeg": np.asarray(jsess.embed_eeg(c["eeg"])),
               "eeg_mvn": np.asarray(jsess.embed_eeg(c["eeg"], normalize=True)),
               "speech": np.asarray(jsess.embed_speech(c["speech"]))}
    path = str(tmp_path_factory.mktemp("serve_shard") / "case.pt")
    torch.save(c, path)
    return path, c, jax_emb


@pytest.fixture(scope="module")
def rank_results(case):
    path = case[0]
    assert launch(N, ranks.serve_job, (path,), device="cpu") == 0
    return [torch.load(os.path.join(os.path.dirname(path), f"serve_rank{r}.pt"),
                       weights_only=False) for r in range(N)]


@pytest.mark.parametrize("what", ["eeg", "eeg_mvn", "speech"])
def test_sharded_session_matches_one_process(case, rank_results, what):
    """Each rank returns the whole ``[11, D]`` result (its rows of every
    padded chunk, the chunk gathered), equal on both ranks and within 1e-6
    of the one-process session; rank 1's own weights were replaced by rank
    0's."""
    _, c, _ = case
    want = ranks.session_embeddings(c)[what]
    a, b = (res["session"][what] for res in rank_results)
    assert a.shape == want.shape == (N_WINDOWS, want.shape[1])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("what", ["eeg", "eeg_mvn", "speech"])
def test_sharded_session_matches_jax_sharded_session(case, rank_results, what):
    """JAX's ``InferenceSession(mesh=make_mesh(2))`` on the same weights,
    within 1e-6."""
    _, _, jax_emb = case
    np.testing.assert_allclose(rank_results[0]["session"][what], jax_emb[what], atol=TOL)


def test_chunk_that_does_not_divide_raises(case):
    """JAX's check, before any collective: a chunk of 5 over 2 ranks."""
    _, c, _ = case
    model = ranks.build_case_model({"model": "config", "config": SMALL, "bank_size": BANK})
    with pytest.raises(ValueError, match=r"chunk 5 must divide by the data axis \(2\)"):
        InferenceSession(model, c["state"], chunk=5, device="cpu",
                         mesh=Mesh(N, 0, torch.device("cpu"), "gloo", N))


def _jax_index_ops(c, mesh=None):
    idx = JIndex.from_embeddings(c["bank"], capacity=c["capacity"], mesh=mesh)
    out = [idx.capacity]
    for op, arg in c["ops"]:
        out.append(idx.topk(c["queries"], arg) if op == "topk" else idx.add(arg))
    return out


def _assert_same_ops(got, want, exact_scores=False):
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if isinstance(g, tuple):
            np.testing.assert_array_equal(g[1], np.asarray(w[1]))  # the indices
            if exact_scores:
                np.testing.assert_array_equal(g[0], np.asarray(w[0]))
            else:
                np.testing.assert_allclose(g[0], np.asarray(w[0]), atol=TOL)
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


def test_sharded_index_matches_one_process_and_jax(case, rank_results):
    """Capacity 21 → 22 (a multiple of the ranks), each rank holding 11 rows;
    top-4, a row added after the build (the index full), top-23 (clamped to
    the 22 rows): the indices equal the one-process index's (of capacity 22)
    and JAX's sharded index's, the scores within 1e-6; both ranks return the
    same."""
    _, c, _ = case
    cc = c["index"]["jax"]
    a, b = (res["index"]["jax"] for res in rank_results)
    assert a[0] == 22 and a[3][1].shape == (3, 22)
    _assert_same_ops(a, b, exact_scores=True)
    _assert_same_ops(a, ranks.index_ops(dict(cc, capacity=22)))
    _assert_same_ops(a, _jax_index_ops(cc, j_make_mesh(N)))


def test_ties_take_lax_top_k_order(case, rank_results):
    """Duplicated rows give equal scores: the lower global index comes first,
    as ``lax.top_k`` orders them, in the one-process index (which used
    ``torch.topk``, whose CPU order for ties is not the index order) and
    across the ranks' merge."""
    _, c, _ = case
    cc = c["index"]["ties"]
    want = _jax_index_ops(cc)
    top = np.asarray(want[1][1])
    assert top[0, :3].tolist() == [2, 5, 15] and top[1, :2].tolist() == [11, 17]
    assert top[2].tolist() == [2, 5, 11, 15, 17]  # a 5-way tie over both ranks
    _assert_same_ops(ranks.index_ops(cc), want)
    for res in rank_results:
        _assert_same_ops(res["index"]["ties"], want)
    _assert_same_ops(rank_results[0]["index"]["ties"], _jax_index_ops(cc, j_make_mesh(N)))


def test_merge_of_ranked_parts_keeps_index_order():
    """``serve._ranked`` on what the merge gets: each rank's local top-k
    (ranked by score, then index) concatenated in rank order, rank 1's
    indices all above rank 0's, ties within a rank and across both, a pad
    row's ``-inf``: one stable sort by score gives ``lax.top_k``'s order."""
    inf = float("inf")
    scores = torch.tensor([[0.5, 0.5, 0.25, 0.5, 0.5, -inf],
                           [0.75, 0.0, -inf, 0.75, 0.0, 0.0]])
    ids = torch.tensor([[1, 4, 0, 6, 9, 11],
                        [3, 0, 5, 7, 8, 10]])
    got_scores, got_ids = serve._ranked(scores, ids, 5)
    assert got_ids.tolist() == [[1, 4, 6, 9, 0], [3, 7, 0, 8, 10]]
    assert got_scores.tolist() == [[0.5, 0.5, 0.5, 0.5, 0.25], [0.75, 0.75, 0.0, 0.0, 0.0]]
    # one process: ids are the rows, [n] for every query
    got_scores, got_ids = serve._ranked(torch.tensor([[0.0, 1.0, 1.0, 0.0]]),
                                        torch.arange(4), 3)
    assert got_ids.tolist() == [[1, 2, 0]] and got_scores.tolist() == [[1.0, 1.0, 0.0]]


def test_empty_index_and_k_clamp(case):
    """An empty index raises, as today, before any collective; ``k`` past
    the rows held is clamped to them."""
    idx = RetrievalIndex(6, capacity=5, device="cpu", mesh=Mesh(N, 1, torch.device("cpu"),
                                                                "gloo", N))
    assert idx.capacity == 6 and idx._bank.shape == (3, 6) and idx._row0 == 3
    with pytest.raises(ValueError, match="index is empty"):
        idx.topk(np.zeros((1, 6), np.float32), 3)
    one = RetrievalIndex.from_embeddings(_unit_rows(np.random.default_rng(1), 3), device="cpu")
    scores, ids = one.topk(np.ones((2, 6), np.float32), 10)
    assert scores.shape == ids.shape == (2, 3) and sorted(ids[0]) == [0, 1, 2]


# -- the command line ------------------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(case, tmp_path_factory):
    """A results directory of the carried weights (``args.txt`` with its
    bank size and the port's checkpoint), and its windows as ``.npy``."""
    _, c, _ = case
    d = tmp_path_factory.mktemp("serve_shard_run")
    cfg = TrainConfig(**SMALL)
    cfg.bank_size = BANK
    cfg.save(str(d / "args.txt"))
    model = ranks.build_case_model({"model": "config", "config": SMALL, "bank_size": BANK,
                                    "state": c["state"]})
    os.makedirs(d / "checkpoints")
    ckpt_lib.save_checkpoint(str(d / "checkpoints"), model,
                             Optimizer(model.parameters(), 1e-3))
    paths = {}
    for k in ("eeg", "speech"):
        paths[k] = str(d / f"{k}.npy")
        np.save(paths[k], c[k])
    return str(d), paths


INVOCATIONS = {"eeg": ["--eeg", "{eeg}", "--mvn"], "speech": ["--speech", "{speech}"],
               "topk": ["--eeg", "{eeg}", "--candidates", "{speech}", "--topk", "3"]}


def _argv(run, name, out, *extra):
    d, paths = run
    return ["--results_folder", d, "--chunk", str(CHUNK), "--out", out, *extra,
            *(a.format(**paths) for a in INVOCATIONS[name])]


@pytest.fixture(scope="module")
def no_shard(run_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("no_shard")
    paths = {}
    for name in INVOCATIONS:
        paths[name] = str(out / (f"{name}.json" if name == "topk" else f"{name}.npy"))
        assert serve.main(_argv(run_dir, name, paths[name]), device="cpu") == 0
    return paths


def _load(path):
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return np.load(path)


@pytest.mark.parametrize("name", list(INVOCATIONS))
def test_serve_main_shard_2_matches_no_shard(run_dir, no_shard, tmp_path, monkeypatch, name):
    """``serve.main --shard 2`` spawns two ranks (gloo on the CPU); rank 0
    writes the ``.npy`` or the retrieval JSON: the embeddings within 1e-6 of
    the one-process CLI's, the retrieval's indices equal and its scores
    within 1e-6."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(ranks.THREADS))
    out = str(tmp_path / os.path.basename(no_shard[name]))
    assert serve.main(_argv(run_dir, name, out, "--shard", "2"), device="cpu") == 0
    got, want = _load(out), _load(no_shard[name])
    if name == "topk":
        assert set(got) == {"indices", "scores"} and got["indices"] == want["indices"]
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL, rtol=0)
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_shard_1_is_no_shard_bit_for_bit(run_dir, no_shard, tmp_path):
    """``--shard 1``: a group of one in this process, every output equal to
    no ``--shard``'s, bit for bit."""
    for name in INVOCATIONS:
        out = str(tmp_path / os.path.basename(no_shard[name]))
        assert serve.main(_argv(run_dir, name, out, "--shard", "1"), device="cpu") == 0
        if name == "topk":
            assert _load(out) == _load(no_shard[name])
        else:
            np.testing.assert_array_equal(_load(out), _load(no_shard[name]))
