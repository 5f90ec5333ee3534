"""The traffic generators: the same seed gives the same inputs, another
seed other inputs, and every seed the same amount of work."""

import numpy as np
import pytest
import torch

from conftest import tiny
from portbench import harness, spec

SEED, OTHER = 2**31 + 12345, 2**31 + 54321


def train_inputs(seed):
    drv = spec.load_module("generators", "train_chunks")
    ctx = harness.make_context("flagship.train", seed, 0.0, False, "cpu",
                               overrides=tiny("flagship.train"))
    cfg = harness.train_config(ctx.config)
    chunks = drv.make_corpus(ctx.traffic, cfg, seed, ctx.device)
    feed = drv.walk(chunks, ctx.traffic, cfg.batch_size, seed, ctx.device)
    items = [next(feed) for _ in range(7)]
    return chunks, [(it[3].copy(), it[4].copy()) for it in items]


def test_train_corpus_and_walk_follow_the_seed():
    a, walk_a = train_inputs(SEED)
    b, walk_b = train_inputs(SEED)
    c, walk_c = train_inputs(OTHER)
    for x, y in zip(a, b):
        assert torch.equal(x["eeg"], y["eeg"]) and torch.equal(x["speech"], y["speech"])
    for (i, s), (j, t) in zip(walk_a, walk_b):
        np.testing.assert_array_equal(i, j)
        np.testing.assert_array_equal(s, t)
    assert not torch.equal(a[0]["eeg"], c[0]["eeg"])
    assert any(not np.array_equal(i, j) for (i, _), (j, _) in zip(walk_a, walk_c))
    # the same work: every chunk's shape and every batch's size
    assert [x["eeg"].shape for x in a] == [x["eeg"].shape for x in c]
    assert [i.shape for i, _ in walk_a] == [i.shape for i, _ in walk_c]


def test_train_walk_draws_distinct_rows_from_real_subjects_and_windows():
    chunks, walk = train_inputs(SEED)
    tr = tiny("flagship.train")["traffic"]
    for idx, subs in walk:
        assert len(set(idx.tolist())) == len(idx)  # windows without replacement
        assert idx.max() < tr["windows_per_chunk"]
        assert subs.max() < max(tr["subjects_per_chunk"])
    padded = chunks[0]["eeg"][tr["subjects_per_chunk"][0]:]
    assert float(padded.abs().sum()) == 0.0


@pytest.mark.parametrize("seed,same", [(SEED, True), (OTHER, False)])
def test_serve_pool_follows_the_seed(seed, same):
    drv = spec.load_module("generators", "open_loop_embed")
    ov = tiny("flagship.serve_eeg")
    cfg = harness.train_config(ov["config"])
    a = drv.make_pool(ov["traffic"], cfg, SEED, torch.device("cpu"))
    b = drv.make_pool(ov["traffic"], cfg, seed, torch.device("cpu"))
    assert a.shape == b.shape
    assert np.array_equal(a, b) == same


def test_serve_schedule_gives_every_seed_the_same_work():
    drv = spec.load_module("generators", "open_loop_embed")
    tr = spec.load_json("traffic", "serve_eeg")
    arr_a, size_a, off_a = drv.schedule(tr, 40.0, SEED)
    arr_b, size_b, off_b = drv.schedule(tr, 40.0, SEED)
    arr_c, size_c, off_c = drv.schedule(tr, 40.0, OTHER)
    for x, y in ((arr_a, arr_b), (size_a, size_b), (off_a, off_b)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(size_a, size_c) and not np.array_equal(off_a, off_c)
    # the same sizes and the same gaps, in another order
    np.testing.assert_array_equal(np.sort(size_a), np.sort(size_c))
    np.testing.assert_allclose(np.sort(np.diff(arr_a)), np.sort(np.diff(arr_c)), atol=1e-2)
    assert len(arr_a) == round(tr["requests_per_s"] * 40.0)
    assert arr_a[0] == 0.0 and arr_a[-1] < 40.0 and np.all(np.diff(arr_a) >= 0)
    assert size_a.min() == tr["windows_min"] and size_a.max() == tr["windows_max"]
    assert np.all(off_a + size_a <= tr["pool_windows"]) and off_a.min() >= 0
    # log-uniform: as many requests of 1 window as of 16-31
    assert abs(np.sum(size_a == 1) - np.sum((size_a >= 16) & (size_a < 32))) < 0.1 * len(size_a)


def test_weights_follow_the_seed():
    ov = tiny("flagship.train")
    cfg = harness.train_config(ov["config"])
    one = harness.build_model(cfg, 24, SEED, "cpu").state_dict()
    two = harness.build_model(cfg, 24, SEED, "cpu").state_dict()
    other = harness.build_model(cfg, 24, OTHER, "cpu").state_dict()
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["eegModel.conv_0.conv.weight"], other["eegModel.conv_0.conv.weight"])
    assert float(one["eegModel.conv_0.normalization.weight"].min()) == 1.0
