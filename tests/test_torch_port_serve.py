"""Torch port, serving: InferenceSession and RetrievalIndex against the JAX
package's on the same weights, and an HTTP round trip over every route, all
with device="cpu"."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from transformer_clip_eeg_tpu.serve import InferenceSession as JSession
from transformer_clip_eeg_tpu.serve import RetrievalIndex as JIndex
from transformer_clip_eeg_tpu.serve import build_model_from_config as j_build
from transformer_clip_eeg_tpu.serve import match_mismatch_decide as j_decide
from transformer_clip_eeg_tpu.train.config import TrainConfig as JConfig
from transformer_clip_eeg_tpu_torch.serve import (
    InferenceSession,
    RetrievalIndex,
    build_model_from_config,
    match_mismatch_decide,
)
from transformer_clip_eeg_tpu_torch.server import (
    NPY_CONTENT_TYPE,
    EmbeddingService,
    make_server,
)
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig
from transformer_clip_eeg_tpu_torch.utils.convert import state_dict_from_jax

T, EEG_C, SP_D, CHUNK = 32, 64, 8, 4
SMALL = dict(window_length_s=1, fs=T, attention_depth=2, latent_dim=4,
             speech_dim_override=SP_D)
ATOL = 1e-4


@pytest.fixture(scope="module")
def sessions():
    """(JAX session, port session) over the same weights."""
    jmodel = j_build(JConfig(**SMALL), bank_size=16)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0),
        rng.standard_normal((2, T, EEG_C)).astype(np.float32),
        rng.standard_normal((2, T, SP_D)).astype(np.float32),
        np.arange(1, 3, dtype=np.int32),
    )))
    tmodel = build_model_from_config(TrainConfig(**SMALL), 16, device="cpu")
    port = InferenceSession(tmodel, state_dict_from_jax(variables, tmodel),
                            chunk=CHUNK, device="cpu")
    return JSession(jmodel, variables, chunk=CHUNK), port


@pytest.mark.parametrize("n", [6, 4, 1], ids=["ragged", "one-chunk", "single"])
@pytest.mark.parametrize("normalize", [False, True])
def test_embed_eeg_matches_jax(sessions, n, normalize):
    jsess, port = sessions
    eeg = (np.random.default_rng(n).standard_normal((n, T, EEG_C)) * 2 + 1).astype(np.float32)
    want = np.asarray(jsess.embed_eeg(eeg, normalize=normalize))
    got = port.embed_eeg(eeg, normalize=normalize)
    assert got.shape == want.shape == (n, T * 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embed_speech_matches_jax(sessions):
    jsess, port = sessions
    speech = np.random.default_rng(7).standard_normal((5, T, SP_D)).astype(np.float32)
    want = np.asarray(jsess.embed_speech(speech))
    got = port.embed_speech(speech)
    assert got.shape == (5, T * 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_empty_input_gives_empty_embeddings(sessions):
    jsess, port = sessions
    for method, c in (("embed_eeg", EEG_C), ("embed_speech", SP_D)):
        empty = np.zeros((0, T, c), np.float32)
        got = getattr(port, method)(empty)
        want = np.asarray(getattr(jsess, method)(empty))
        assert got.shape == want.shape == (0, T * 4)
        assert got.dtype == np.float32


def test_from_results_dir_keeps_the_runs_config(sessions, tmp_path):
    """As the JAX session: ``cfg`` is None on a session built from a model
    and the run's config on one built from a results directory."""
    import os

    import torch

    _, port = sessions
    assert port.cfg is None
    cfg = TrainConfig(**SMALL, bank_size=16)
    cfg.save(str(tmp_path / "args.txt"))
    os.makedirs(tmp_path / "checkpoints")
    torch.save({"model": port.model.state_dict()}, tmp_path / "checkpoints" / "model_ckpt.pt")
    served = InferenceSession.from_results_dir(str(tmp_path), chunk=CHUNK, device="cpu")
    assert isinstance(served.cfg, TrainConfig) and served.cfg.to_dict() == cfg.to_dict()
    eeg = np.random.default_rng(9).standard_normal((3, T, EEG_C)).astype(np.float32)
    np.testing.assert_array_equal(served.embed_eeg(eeg), port.embed_eeg(eeg))


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_retrieval_index_matches_jax():
    rng = np.random.default_rng(8)
    bank, q, extra = _unit(rng, (20, 6)), _unit(rng, (4, 6)), _unit(rng, (3, 6))
    port = RetrievalIndex.from_embeddings(bank, capacity=32, device="cpu")
    jidx = JIndex.from_embeddings(bank, capacity=32)
    for k in (1, 5, 50):  # k above the size is cut to the size
        s, i = port.topk(q, k=k)
        js, ji = jidx.topk(q, k=k)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, atol=1e-5)
    assert list(port.add(extra)) == list(jidx.add(extra)) == [20, 21, 22]
    s, i = port.topk(q, k=23)
    js, ji = jidx.topk(q, k=23)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, atol=1e-5)
    with pytest.raises(ValueError, match="full"):
        port.add(np.zeros((10, 6), np.float32))
    with pytest.raises(ValueError, match="empty"):
        RetrievalIndex(6, capacity=4, device="cpu").topk(q)


def test_match_mismatch_decide_matches_jax():
    rng = np.random.default_rng(9)
    e, a, b = _unit(rng, (16, 5)), _unit(rng, (16, 5)), _unit(rng, (16, 5))
    np.testing.assert_array_equal(match_mismatch_decide(e, a, b), j_decide(e, a, b))
    hand = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(
        match_mismatch_decide(hand, hand[[0, 0]], hand[[1, 1]]), [0, 1])


@pytest.fixture(scope="module")
def server(sessions):
    _, port = sessions
    service = EmbeddingService(port, RetrievalIndex(T * 4, capacity=16, device="cpu"),
                               info={"model_arch": "clip_sim_no_latent_proj"})
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", port
    httpd.shutdown()
    httpd.server_close()
    service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, payload=None, body=None, headers=None):
    data = body if body is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        raw, ctype = resp.read(), resp.headers.get("Content-Type", "")
    return np.load(io.BytesIO(raw)) if ctype.startswith(NPY_CONTENT_TYPE) else json.loads(raw)


def test_server_round_trip_every_route(server):
    url, port = server
    rng = np.random.default_rng(10)
    eeg = rng.standard_normal((5, T, EEG_C)).astype(np.float32)
    speech = rng.standard_normal((6, T, SP_D)).astype(np.float32)

    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["index_capacity"] == 16

    got = np.asarray(_post(f"{url}/v1/embed/eeg", {"windows": eeg.tolist(),
                                                    "normalize": True})["embeddings"])
    np.testing.assert_allclose(got, port.embed_eeg(eeg, normalize=True), atol=1e-6)

    buf = io.BytesIO()
    np.save(buf, speech)
    sp = _post(f"{url}/v1/embed/speech", body=buf.getvalue(),
               headers={"Content-Type": NPY_CONTENT_TYPE, "Accept": NPY_CONTENT_TYPE})
    np.testing.assert_allclose(sp, port.embed_speech(speech), atol=1e-6)

    added = _post(f"{url}/v1/retrieval/add", {"embeddings": sp.tolist()})
    assert added == {"ids": list(range(6)), "size": 6}
    added = _post(f"{url}/v1/retrieval/add", {"windows": speech[:2].tolist()})
    assert added == {"ids": [6, 7], "size": 8}

    top = _post(f"{url}/v1/retrieval/topk", {"windows": eeg[:2].tolist(), "k": 3})
    q = port.embed_eeg(eeg[:2])
    cands = np.concatenate([sp, sp[:2]])
    want = np.argsort(-(q @ cands.T), axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(top["ids"], want)

    mm = _post(f"{url}/v1/match_mismatch", {"eeg": eeg[:3].tolist(),
                                            "cand_a": speech[:3].tolist(),
                                            "cand_b": speech[3:6].tolist()})
    want_dec = match_mismatch_decide(port.embed_eeg(eeg[:3]), sp[:3], sp[3:6])
    assert mm["decisions"] == want_dec.tolist()

    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{url}/v1/no_such_route", {})
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{url}/v1/retrieval/topk", {"queries": q.tolist(), "k": 0})
    assert err.value.code == 400


def test_micro_batcher_coalesces_concurrent_requests(sessions):
    _, port = sessions
    service = EmbeddingService(port, batch_window_ms=50.0)
    rng = np.random.default_rng(11)
    eegs = [rng.standard_normal((2, T, EEG_C)).astype(np.float32) for _ in range(4)]
    out = [None] * 4

    def call(i):
        out[i] = service.embed_eeg({"windows": eegs[i]})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        for i in range(4):
            np.testing.assert_allclose(out[i], port.embed_eeg(eegs[i]), atol=1e-5)
        health = service.healthz()["batching"]
        assert health["requests"] == 4 and health["dispatches"] < 4
    finally:
        service.close()
