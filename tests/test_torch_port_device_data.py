"""Torch port, the device-resident chunk store (``train/device_data.py``)
against the JAX package's on the CPU: the sampling walk, the padded chunks,
the gather, the bf16 rounding, Belady eviction and the shared budget; then
the trainer's device mode against its host mode, and the host mode against
a plain loop of train steps."""

import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

from transformer_clip_eeg_tpu.data.dataset import EEGWindowDataset as JDataset
from transformer_clip_eeg_tpu.train.device_data import DeviceChunkStore as JStore
from transformer_clip_eeg_tpu.train.device_data import gather_batch as j_gather
from transformer_clip_eeg_tpu_torch.data.dataset import EEGWindowDataset
from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture
from transformer_clip_eeg_tpu_torch.models.registry import build_model_from_config
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.train import device_data
from transformer_clip_eeg_tpu_torch.train.device_data import DeviceChunkStore, gather_batch
from transformer_clip_eeg_tpu_torch.train.loop import Trainer, batch_iterator
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer
from transformer_clip_eeg_tpu_torch.train.steps import train_step

SP_D, WL, BS = 16, 64, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier-1 run shares the host's cores among several test workers;
    torch's default of one thread a core makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparrkulee_store"))
    # 7 chunks per story at batch 4: enough to evict from a 2-chunk store
    make_fixture(root, n_stories=3, n_subjects=3, story_seconds=30, speech_dim=SP_D)
    return root


def _files(root):
    return get_train_val_test_files_final(root, 0, "wav2vec_19", f"{root}/fold_split.json", 3)


def _datasets(root, cls, split=0, seed=0):
    files = _files(root)
    return cls(files[split], files[4 + split], WL, WL, batch_size=BS, shuffle=True,
               shuffle_percentage=1.0, seed=seed)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("walk", ["epoch_batches", "epoch_chunk_batches"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["plain", "in_order"])
def test_epoch_walk_and_padded_chunks_match_jax(root, walk, shuffle):
    """The same draws from ``dataset.rng`` in the same order: equal index
    matrices (the mixup partners too, ``subs`` again when mixup is off) and
    padded chunks of equal shape and content, chunk after chunk over two
    epochs."""
    mine = DeviceChunkStore(_datasets(root, EEGWindowDataset), device="cpu", prefetch=False)
    theirs = JStore(_datasets(root, JDataset), prefetch=False)
    n = 0
    for _ in range(2):
        for a, b in zip(getattr(mine, walk)(shuffle=shuffle), getattr(theirs, walk)(shuffle=shuffle),
                        strict=True):
            for x, y in zip(a[:3], b[:3]):
                assert tuple(x.shape) == tuple(y.shape)
                np.testing.assert_array_equal(_np(x), _np(y))
            # idx, subs and partners, then n for a chunk walk
            for x, y in zip(a[3:], b[3:], strict=True):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert a[3].dtype == np.int64 and a[5].dtype == np.int64
            n += 1
    assert n > 10
    assert mine.dataset.rng.integers(1 << 30) == theirs.dataset.rng.integers(1 << 30)


def test_gather_batch_matches_jax(root):
    ds = _datasets(root, EEGWindowDataset)
    store = DeviceChunkStore(ds, device="cpu", prefetch=False)
    theirs = JStore(_datasets(root, JDataset), prefetch=False)
    rng = np.random.default_rng(0)
    for key in ds.batches_keys[:4]:
        eeg, sp, ids, n_subs, n_win = store.get(key)
        jeeg, jsp, jids, _, _ = theirs.get(key)
        idx = rng.choice(n_win, BS, replace=False)
        subs = rng.integers(0, n_subs, BS)
        got = gather_batch(eeg, sp, ids, torch.from_numpy(idx), torch.from_numpy(subs))
        want = j_gather(jeeg, jsp, jids, idx.astype(np.int32), subs.astype(np.int32))
        assert set(got) == set(want) and got["eeg"].dtype == torch.float32 and got["ids"].dtype == torch.int64
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        # and the host path's own gather of the same rows
        chunk = ds.chunks[key]
        np.testing.assert_array_equal(got["eeg"].numpy(),
                                      chunk["eeg"][subs, idx].astype(np.float32))
        np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(chunk["identifiers"])[idx])


def test_bf16_store_rounds_as_ml_dtypes(root):
    """bfloat16 chunks hold the bits ``ml_dtypes`` gives (round to nearest
    even), and the gather hands back their f32 values."""
    ds = _datasets(root, EEGWindowDataset)
    store = DeviceChunkStore(ds, device="cpu", prefetch=False, store_dtype="bfloat16")
    theirs = JStore(_datasets(root, JDataset), prefetch=False, store_dtype="bfloat16")
    for key in ds.batches_keys[:3]:
        eeg, sp, ids, n_subs, n_win = store._pad_chunk(key)
        jeeg, jsp, jids, _, _ = theirs._pad_chunk(key)
        assert eeg.dtype == torch.bfloat16
        for x, y in ((eeg, jeeg), (sp, jsp)):
            np.testing.assert_array_equal(x.view(torch.int16).numpy().view(np.uint16),
                                          y.view(np.uint16))
        np.testing.assert_array_equal(ids.numpy(), jids)
        idx = torch.arange(BS)
        batch = gather_batch(eeg, sp, ids, idx, torch.zeros(BS, dtype=torch.int64))
        assert batch["eeg"].dtype == torch.float32
        np.testing.assert_array_equal(batch["speech"].numpy(),
                                      np.asarray(jsp[:BS]).astype(np.float32))
    # 2 bytes a value instead of 4
    full = DeviceChunkStore(ds, device="cpu", prefetch=False)
    store.get(ds.batches_keys[0])
    full.get(ds.batches_keys[0])
    assert store.stats["upload_bytes"] < 0.51 * full.stats["upload_bytes"] + 8 * 64


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 0, 4, 1, 5], [5, 4, 3, 2, 1, 0, 6, 3]])
def test_belady_eviction_picks_the_jax_victim(root, order):
    """With room for two chunks, each insert evicts the resident chunk whose
    next use is farthest (never the one in use): the resident set after
    every step equals the JAX store's."""
    ds = _datasets(root, EEGWindowDataset)
    mine = DeviceChunkStore(ds, device="cpu", prefetch=False, max_resident=2)
    theirs = JStore(_datasets(root, JDataset), prefetch=False, max_resident=2)
    keys = [ds.batches_keys[i] for i in order]
    for j, key in enumerate(keys):
        for store in (mine, theirs):
            store._set_upcoming(keys[j:] + keys[:j])
            store.get(key)
        assert list(mine._resident) == list(theirs._resident)
        assert key in mine._resident
    assert mine.stats["uploads"] == theirs.stats["uploads"]


def test_budgeted_stores_share_one_ledger_as_in_jax(root, monkeypatch):
    """Two budgeted stores on one device (train and validation) cap their
    combined residency: with a budget of two chunks, the second store's
    inserts evict its own chunks once the first holds one, as the JAX
    ledger does; release() returns every byte."""
    def run(store_cls, ds_cls, **kw):
        probe = store_cls(_datasets(root, ds_cls), prefetch=False, max_resident=8, **kw)
        probe.get(probe.dataset.batches_keys[0])
        per_chunk = probe.stats["upload_bytes"]
        monkeypatch.setattr(store_cls, "_auto_budget", lambda self, frac: int(2.5 * per_chunk))
        train = store_cls(_datasets(root, ds_cls), prefetch=False, **kw)
        val = store_cls(_datasets(root, ds_cls, split=1), prefetch=False, **kw)
        trace = []
        for i in range(3):
            train.get(train.dataset.batches_keys[i])
            val.get(val.dataset.batches_keys[i])
            trace.append((len(train._resident), len(val._resident)))
        ledger = dict(store_cls._ledger[train._device_key])
        train.release()
        val.release()
        left = store_cls._ledger[train._device_key]["resident"]
        return trace, ledger["resident"] // per_chunk, left

    mine = run(DeviceChunkStore, EEGWindowDataset, device="cpu")
    theirs = run(JStore, JDataset)
    assert mine == theirs
    assert mine[2] == 0


def test_prefetch_on_and_off_give_the_same_batches(root):
    """The background upload changes no draw: every gathered batch of two
    epochs is equal with prefetch on and off, under a short switch
    interval.  A 2-chunk store uploads each chunk about once an epoch (a
    chunk still resident from the epoch before is not uploaded again)."""
    batches = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for prefetch in (False, True):
            store = DeviceChunkStore(_datasets(root, EEGWindowDataset), device="cpu",
                                     prefetch=prefetch)
            out = []
            for _ in range(2):
                for eeg, sp, ids, idx, subs, _partner in store.epoch_batches():
                    b = gather_batch(eeg, sp, ids, torch.from_numpy(idx), torch.from_numpy(subs))
                    out.append({k: v.clone() for k, v in b.items()})
            store.release()
            assert store._pool is None and not store._resident
            batches[prefetch] = (out, store.stats["uploads"])
    finally:
        sys.setswitchinterval(old)
    (plain, n_plain), (pre, n_pre) = batches[False], batches[True]
    assert len(plain) == len(pre) > 20
    for a, b in zip(plain, pre):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    n_chunks = len(_datasets(root, EEGWindowDataset).batches_keys)
    assert 2 * n_chunks - 2 <= min(n_plain, n_pre) and max(n_plain, n_pre) <= 2 * n_chunks


def test_an_upload_error_is_raised_in_get(root, monkeypatch):
    store = DeviceChunkStore(_datasets(root, EEGWindowDataset), device="cpu")
    bad = store.dataset.batches_keys[1]
    real = store._pad_chunk

    def pad(key):
        if key == bad:
            raise OSError("injected upload failure")
        return real(key)

    monkeypatch.setattr(store, "_pad_chunk", pad)
    store.get(store.dataset.batches_keys[0])
    store.prefetch_key(bad)
    with pytest.raises(OSError, match="injected"):
        store.get(bad)
    store.release()


# -- the trainer's two data paths ---------------------------------------------

def _config(root, **kw):
    base = dict(data_dir=root, run=0, batch_size=BS, epochs=2, patience=5, attention_depth=1,
                latent_dim=4, window_length_s=1, fs=WL, number_of_training_subjects=3,
                speech_dim_override=SP_D, shuffle="yes")
    base.update(kw)
    return TrainConfig(**base)


def _trainer(root, tmp_path, mode, **kw):
    cfg = _config(root, data_mode=mode, **kw)
    tr = _datasets(root, EEGWindowDataset)
    va = _datasets(root, EEGWindowDataset, split=1)
    return Trainer(cfg, tr, va, results_dir=str(tmp_path / mode), device="cpu")


@pytest.fixture(scope="module")
def both_modes(root, tmp_path_factory):
    out = {}
    for mode in ("device", "host"):
        trainer = _trainer(root, tmp_path_factory.mktemp(mode), mode)
        out[mode] = (trainer, trainer.fit())
    return out


LOSS_NUMBER = re.compile(r"(?:loss_ce|loss average eeg|mean loss ce :|mean loss average:|"
                         r"mean loss total:) (-?[\d.e+-]+)")


def test_device_and_host_modes_give_equal_losses_and_bank(both_modes):
    (dev, dev_out), (host, host_out) = both_modes["device"], both_modes["host"]
    assert dev.device_data and not host.device_data
    nums = {m: [float(v) for v in LOSS_NUMBER.findall(open(t.loss_file).read())]
            for m, (t, _) in both_modes.items()}
    assert len(nums["device"]) == 2 * 5 and nums["device"] == nums["host"]
    assert [h["val_loss_ce"] for h in dev_out["history"]] == \
        [h["val_loss_ce"] for h in host_out["history"]]
    for (name, a), (_, b) in zip(dev.model.state_dict().items(),
                                 host.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert [len(h["step_s"]) for h in dev_out["history"]] == \
        [len(h["step_s"]) for h in host_out["history"]]


def test_device_mode_scans_a_chunks_bucket_aligned_prefix(root, tmp_path, both_modes,
                                                          monkeypatch):
    """With a subject bucket of 2, each 3-subject chunk runs its first two
    batches as one item (the JAX trainer's scan) and the third alone: the
    weights, the bank and the validation losses are still the host mode's,
    and every step keeps its own step time."""
    monkeypatch.setattr(device_data, "SUBS_BUCKET", 2)
    trainer = _trainer(root, tmp_path, "device")
    out = trainer.fit()
    host, host_out = both_modes["host"]
    assert [h["val_loss_ce"] for h in out["history"]] == \
        [h["val_loss_ce"] for h in host_out["history"]]
    for (name, a), (_, b) in zip(trainer.model.state_dict().items(),
                                 host.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert [len(h["step_s"]) for h in out["history"]] == \
        [len(h["step_s"]) for h in host_out["history"]]
    assert trainer.chunk_store.dataset.chunks[trainer.chunk_store.dataset.batches_keys[0]][
        "eeg"].shape[0] == 3


# the JAX trainer's lines in device mode, in order per epoch
DEVICE_LINES = [
    r"number of parameters \d+",
    r"no model found at .*, training from scratch",
] + [line.replace("{e}", str(e)) for e in range(2) for line in (
    r"train epoch {e} batch 0 loss_ce \S+ loss average eeg \S+",
    r"epoch {e} done in \d+\.\ds \(\d+ pairs/s\)",
    r'epoch {e} phases \{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+, '
    r'"uploads": (\d+), "upload_gb": \S+, "upload_s": \S+, "upload_wait_s": \S+\}',
    r"validation epoch {e}: mean loss ce : \S+, mean loss average: \S+, mean loss total: \S+",
)]


def test_device_mode_writes_the_jax_device_mode_lines(both_modes):
    trainer, _ = both_modes["device"]
    lines = open(trainer.loss_file).read().splitlines()
    assert len(lines) == len(DEVICE_LINES)
    uploads = []
    for line, fmt in zip(lines, DEVICE_LINES):
        m = re.fullmatch(fmt, line)
        assert m, (line, fmt)
        uploads += [int(v) for v in m.groups()]
    # the CPU store holds two chunks: epoch 0 uploads every chunk, epoch 1
    # all but those still resident that it walks first
    n_chunks = sum("eeg" in c for c in trainer.chunk_store.dataset.chunks.values())
    assert uploads[0] == n_chunks and n_chunks - 2 <= uploads[1] <= n_chunks
    phases = json.loads(lines[4].split("phases ")[1])
    assert phases["upload_gb"] >= 0 and phases["upload_wait_s"] >= 0


def test_data_mode_auto_is_the_host_path_on_the_cpu(root, tmp_path):
    trainer = _trainer(root, tmp_path, "auto")
    assert not trainer.device_data and not hasattr(trainer, "chunk_store")
    with pytest.raises(ValueError, match="data_mode"):
        _trainer(root, tmp_path, "remote")


def test_host_mode_trains_as_a_plain_loop_of_steps(root, tmp_path):
    """One host-mode epoch leaves the weights bit for bit where a plain loop
    of ``train_step`` over ``batch_iterator`` leaves them."""
    trainer = _trainer(root, tmp_path, "host", epochs=1)
    trainer.fit()
    cfg = trainer.cfg
    ds = _datasets(root, EEGWindowDataset)
    next(batch_iterator(ds))  # the trainer's initial draw
    model = build_model_from_config(cfg, cfg.bank_size, device="cpu", seed=cfg.seed)
    opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
                         cfg.beta2, cfg.weight_decay, cfg.amsgrad_b)
    for batch in batch_iterator(ds):
        train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg.seed + 1, False)
    for (name, a), b in zip(trainer.model.named_parameters(), model.parameters()):
        assert torch.equal(a, b), name


def test_release_drops_the_stores_and_the_datasets(root, tmp_path):
    trainer = _trainer(root, tmp_path, "device")
    store = trainer.chunk_store
    assert sum(1 for _ in store.epoch_chunk_batches()) > 2
    assert store._resident and store._pool is not None
    trainer.release_host_data()
    assert not store._resident and store._pool is None and store._resident_bytes == 0
    assert trainer.train_dataset is None and not store.dataset.chunks


def test_jax_and_the_port_draw_the_same_trainer_init(root):
    """Both trainers draw one example batch at construction; the stores'
    walks then start from the same rng state (checked against JAX's)."""
    mine = _datasets(root, EEGWindowDataset)
    theirs = _datasets(root, JDataset)
    next(batch_iterator(mine))
    from transformer_clip_eeg_tpu.train.loop import batch_iterator as j_iter

    next(j_iter(theirs))
    a = next(DeviceChunkStore(mine, device="cpu", prefetch=False).epoch_batches())
    b = next(JStore(theirs, prefetch=False).epoch_batches())
    np.testing.assert_array_equal(a[3], b[3])
    assert jax.default_backend() == "cpu"
