"""Online HTTP serving: a zero-dependency endpoint around an inference session.

The torch package's copy of ``transformer_clip_eeg_tpu/server.py`` (stdlib
plus numpy), bound to :class:`transformer_clip_eeg_tpu_torch.serve.
InferenceSession` and :class:`~transformer_clip_eeg_tpu_torch.serve.
RetrievalIndex`.  Endpoints::

    GET  /healthz                 -> {"status": "ok", ...model info}
    POST /v1/embed/eeg            {"windows": [N][T][64], "normalize": bool}
    POST /v1/embed/speech         {"windows": [N][T][F]}
    POST /v1/retrieval/add        {"embeddings": [N][D]} | {"windows": [N][T][F]}
    POST /v1/retrieval/topk       {"queries": [Q][D]} | {"windows": [Q][T][64]},
                                  optional "k" (default 10)
    POST /v1/match_mismatch       {"eeg": [N][T][64], "cand_a": [N][T][F],
                                  "cand_b": [N][T][F]}

Array transport: JSON nested lists by default; send
``Content-Type: application/x-npy`` with an ``np.save`` body (options moved
to query params, e.g. ``?normalize=1``/``?k=5``) for bulk traffic, and set
``Accept: application/x-npy`` to get embeddings back the same way.

Concurrency: the threaded server parses and encodes requests concurrently;
one lock serialises the device work.  With ``batch_window_ms > 0`` a
:class:`MicroBatcher` per embedder coalesces concurrent requests into one
dispatch.  :func:`main` is the command line: ``python -m
transformer_clip_eeg_tpu_torch.server --results_folder <run dir>`` serves a
run the port's trainer wrote.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

NPY_CONTENT_TYPE = "application/x-npy"


def _coerce_query_value(val: str):
    """Map a query-param string to the JSON value it stands for.

    Booleans must be recognized explicitly: ``?normalize=false`` left as the
    string ``"false"`` would be *truthy* and silently enable normalization.
    """
    low = val.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        # int() is the authority — isdigit() admits strings int() rejects
        # (e.g. '--5', superscript digits), which would 500 downstream
        return int(val)
    except ValueError:
        return val


class ServiceError(Exception):
    """Client-visible error with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class MicroBatcher:
    """Dynamic micro-batching: coalesce concurrent embed requests into one
    device dispatch.

    Each dispatch pays a fixed cost (host-device copies, kernel launches),
    so N concurrent small requests pay it N times when serialized.  A
    worker thread lingers ``window_ms`` after the first
    arrival, drains everything that queued meanwhile, groups by window
    shape, and runs one ``fn`` call per group — N requests, one dispatch.
    Each caller blocks in :meth:`submit` until its slice of the batched
    result is ready; a failing group only fails its own requests.
    """

    def __init__(self, fn, window_ms: float = 3.0):
        self.fn = fn  # [N, T, F] float32 -> [N, D]
        self.window_ms = float(window_ms)
        self._cond = threading.Condition()
        self._pending: list = []
        self._closed = False
        # telemetry for /healthz: how well coalescing is working
        self.requests = 0
        self.dispatches = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, arr: np.ndarray) -> np.ndarray:
        item = {"arr": arr, "event": threading.Event(), "out": None,
                "err": None}
        with self._cond:
            if self._closed:
                raise ServiceError(503, "server shutting down")
            self._pending.append(item)
            self._cond.notify()
        item["event"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=5)

    def _loop(self):
        import time

        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
            # linger outside the lock so stragglers can join the batch
            if self.window_ms > 0:
                time.sleep(self.window_ms / 1000.0)
            with self._cond:
                batch, self._pending = self._pending, []
            groups: dict = {}
            for item in batch:
                groups.setdefault(item["arr"].shape[1:], []).append(item)
            for items in groups.values():
                self.requests += len(items)
                self.dispatches += 1
                try:
                    out = self.fn(
                        np.concatenate([i["arr"] for i in items], axis=0)
                    )
                    ofs = 0
                    for i in items:
                        n = i["arr"].shape[0]
                        i["out"] = out[ofs:ofs + n]
                        ofs += n
                except Exception as e:  # noqa: BLE001 — delivered per item
                    for i in items:
                        i["err"] = e
                finally:
                    for i in items:
                        i["event"].set()


class EmbeddingService:
    """Route logic, separated from HTTP plumbing for direct unit testing.

    ``index`` is optional; retrieval routes 400 without one.  All device
    work runs under one lock (one card; the host-side JSON work is what the
    threaded server parallelizes).
    """

    def __init__(self, session, index=None, info: Optional[dict] = None,
                 batch_window_ms: float = 0.0):
        self.session = session
        self.index = index
        self.info = dict(info or {})
        self._lock = threading.Lock()
        if batch_window_ms > 0:
            self._eeg_batcher = MicroBatcher(
                self._device_embed_eeg, batch_window_ms
            )
            self._speech_batcher = MicroBatcher(
                self._device_embed_speech, batch_window_ms
            )
        else:
            self._eeg_batcher = self._speech_batcher = None

    def close(self):
        """Stop the micro-batch workers (no-op when batching is off)."""
        for b in (self._eeg_batcher, self._speech_batcher):
            if b is not None:
                b.close()

    # -- embedding backends -------------------------------------------------

    def _device_embed_eeg(self, windows: np.ndarray) -> np.ndarray:
        with self._lock:
            return np.asarray(self.session.embed_eeg(windows))

    def _device_embed_speech(self, windows: np.ndarray) -> np.ndarray:
        with self._lock:
            return np.asarray(self.session.embed_speech(windows))

    def _embed_eeg(self, windows: np.ndarray) -> np.ndarray:
        if self._eeg_batcher is not None:
            return self._eeg_batcher.submit(windows)
        return self._device_embed_eeg(windows)

    def _embed_speech(self, windows: np.ndarray) -> np.ndarray:
        if self._speech_batcher is not None:
            return self._speech_batcher.submit(windows)
        return self._device_embed_speech(windows)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _array(payload: dict, *keys: str) -> np.ndarray:
        for key in keys:
            if key in payload:
                try:
                    return np.asarray(payload[key], np.float32)
                except (TypeError, ValueError) as e:
                    raise ServiceError(400, f"field '{key}' is not a numeric "
                                           f"array: {e}")
        raise ServiceError(
            400, f"missing required field: one of {'/'.join(keys)}"
        )

    def _require_index(self):
        if self.index is None:
            raise ServiceError(
                400, "no retrieval index configured (start the server with "
                     "--candidates or --capacity)"
            )
        return self.index

    # -- routes ------------------------------------------------------------

    def healthz(self) -> dict:
        out = {"status": "ok", **self.info}
        if self.index is not None:
            out["index_size"] = int(self.index.size)
            out["index_capacity"] = int(self.index.capacity)
        if self._eeg_batcher is not None:
            out["batching"] = {
                "window_ms": self._eeg_batcher.window_ms,
                "requests": self._eeg_batcher.requests
                + self._speech_batcher.requests,
                "dispatches": self._eeg_batcher.dispatches
                + self._speech_batcher.dispatches,
            }
        return out

    def embed_eeg(self, payload: dict) -> np.ndarray:
        windows = self._array(payload, "windows")
        if windows.ndim != 3:
            raise ServiceError(400, f"windows must be [N, T, C], got "
                                    f"shape {windows.shape}")
        if payload.get("normalize", False):
            # the eval-time MVN contract is a per-request batch statistic
            # over (segments, time) (serve.InferenceSession.embed_eeg), so
            # it must be applied before requests coalesce
            mu = windows.mean(axis=(0, 1), keepdims=True)
            sd = windows.std(axis=(0, 1), keepdims=True)
            windows = (windows - mu) / np.where(sd == 0, 1.0, sd)
        return self._embed_eeg(windows)

    def embed_speech(self, payload: dict) -> np.ndarray:
        windows = self._array(payload, "windows")
        if windows.ndim != 3:
            raise ServiceError(400, f"windows must be [N, T, F], got "
                                    f"shape {windows.shape}")
        return self._embed_speech(windows)

    def retrieval_add(self, payload: dict) -> dict:
        index = self._require_index()
        arr = self._array(payload, "embeddings", "windows")
        if arr.ndim == 3:  # speech windows → embed first (coalescable)
            arr = self._embed_speech(arr)
        elif arr.ndim != 2:
            raise ServiceError(400, "embeddings must be [N, D] (or "
                                    "windows [N, T, F])")
        with self._lock:
            try:
                ids = index.add(arr)
            except ValueError as e:  # index full / dim mismatch
                raise ServiceError(409, str(e))
        return {"ids": np.asarray(ids).tolist(), "size": int(index.size)}

    def retrieval_topk(self, payload: dict) -> dict:
        index = self._require_index()
        arr = self._array(payload, "queries", "windows")
        try:
            k = int(payload.get("k", 10))
        except (TypeError, ValueError):
            raise ServiceError(
                400, f"k must be an integer, got {payload.get('k')!r}"
            )
        if k < 1:
            raise ServiceError(400, f"k must be >= 1, got {k}")
        if arr.ndim == 3:  # EEG windows → embed first (coalescable)
            arr = self._embed_eeg(arr)
        elif arr.ndim != 2:
            raise ServiceError(400, "queries must be [Q, D] (or "
                                    "windows [Q, T, C])")
        with self._lock:
            try:
                scores, ids = index.topk(arr, k=k)
            except ValueError as e:  # empty index
                raise ServiceError(409, str(e))
        return {"scores": scores.tolist(), "ids": ids.tolist()}

    def match_mismatch(self, payload: dict) -> dict:
        from transformer_clip_eeg_tpu_torch.serve import match_mismatch_decide

        eeg = self._array(payload, "eeg")
        cand_a = self._array(payload, "cand_a")
        cand_b = self._array(payload, "cand_b")
        eeg_emb = self._embed_eeg(eeg)
        # both candidate sets share the speech embedder: in batching mode
        # stack them into one submit so they ride one dispatch
        if self._speech_batcher is not None and (
            cand_a.shape[1:] == cand_b.shape[1:]
        ):
            both = self._embed_speech(
                np.concatenate([cand_a, cand_b], axis=0)
            )
            emb_a, emb_b = both[: len(cand_a)], both[len(cand_a):]
        else:
            emb_a = self._embed_speech(cand_a)
            emb_b = self._embed_speech(cand_b)
        decisions = match_mismatch_decide(eeg_emb, emb_a, emb_b)
        return {"decisions": decisions.tolist()}


class _Handler(BaseHTTPRequestHandler):
    """HTTP plumbing: body decode (JSON / .npy), route dispatch, encode."""

    service: EmbeddingService  # set on the subclass by make_server
    protocol_version = "HTTP/1.1"

    # route -> (method name, name of the array field an .npy body fills)
    POST_ROUTES = {
        "/v1/embed/eeg": ("embed_eeg", "windows"),
        "/v1/embed/speech": ("embed_speech", "windows"),
        "/v1/retrieval/add": ("retrieval_add", "embeddings"),
        "/v1/retrieval/topk": ("retrieval_topk", "queries"),
        "/v1/match_mismatch": ("match_mismatch", None),
    }

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # quiet by default; access logging is the proxy's job

    def _send_json(self, status: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_npy(self, arr: np.ndarray):
        buf = io.BytesIO()
        np.save(buf, arr)
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", NPY_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib casing
        self._drain_body()  # a GET body is unusual but legal; keep-alive sync
        if urlparse(self.path).path == "/healthz":
            self._send_json(200, self.service.healthz())
        else:
            self._send_json(404, {"error": f"no such route: {self.path}"})

    def _drain_body(self):
        """Consume the declared request body so HTTP/1.1 keep-alive stays in
        sync when we reply without parsing it (e.g. 404): unread body bytes
        would otherwise be parsed as the next request line."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            # body length unknowable → the connection can't be resynced
            self.close_connection = True
            length = 0
        while length > 0:
            chunk = self.rfile.read(min(length, 1 << 20))
            if not chunk:
                break
            length -= len(chunk)

    def do_POST(self):  # noqa: N802 — stdlib casing
        url = urlparse(self.path)
        route = self.POST_ROUTES.get(url.path)
        if route is None:
            self._drain_body()
            self._send_json(404, {"error": f"no such route: {url.path}"})
            return
        method, npy_field = route
        try:
            payload = self._read_payload(url, npy_field)
            result = getattr(self.service, method)(payload)
        except ServiceError as e:
            self._send_json(e.status, {"error": str(e)})
            return
        except json.JSONDecodeError as e:
            self._send_json(400, {"error": f"invalid JSON body: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — model/shape errors -> 500
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if isinstance(result, np.ndarray):
            if NPY_CONTENT_TYPE in self.headers.get("Accept", ""):
                self._send_npy(result)
            else:
                self._send_json(200, {"embeddings": result.tolist()})
        else:
            self._send_json(200, result)

    def _read_payload(self, url, npy_field: Optional[str]) -> dict:
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            # the body length is unknowable, so keep-alive can't resync —
            # close after replying instead of desyncing the next request
            self.close_connection = True
            raise ServiceError(400, "invalid Content-Length header")
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "application/json")
        if ctype.startswith(NPY_CONTENT_TYPE):
            if npy_field is None:
                raise ServiceError(
                    400, "this route needs several arrays; use JSON"
                )
            try:
                arr = np.load(io.BytesIO(body), allow_pickle=False)
            except (ValueError, EOFError, OSError) as e:
                # np.load raises EOFError on an empty body and OSError on
                # truncated magic — all are malformed client input, not 500s
                raise ServiceError(400, f"invalid .npy body: {e}")
            payload: dict = {npy_field: arr}
            for key, vals in parse_qs(url.query).items():
                payload[key] = _coerce_query_value(vals[0])
            return payload
        return json.loads(body or b"{}")


def make_server(
    service: EmbeddingService, host: str = "127.0.0.1", port: int = 8321
) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server to ``service`` (``port=0`` → ephemeral)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None, device="cuda") -> int:
    """Serve a trained run directory over HTTP until interrupted (SIGINT)."""
    ap = argparse.ArgumentParser(description="Serve a trained run directory over HTTP")
    ap.add_argument("--results_folder", type=str, required=True,
                    help="run dir with args.txt + checkpoints/")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321, help="0 = any free port")
    ap.add_argument("--chunk", type=int, default=128,
                    help="embedder batch (requests are padded up)")
    ap.add_argument("--candidates", type=str, default="",
                    help=".npy of [N, T, F] speech windows to pre-embed "
                         "into the retrieval index")
    ap.add_argument("--capacity", type=int, default=0,
                    help="retrieval index capacity; 0 disables retrieval "
                         "unless --candidates is given")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="dynamic micro-batching: linger this long after a "
                         "request arrives and coalesce everything that "
                         "queued into one device dispatch (0 = off)")
    ap.add_argument("--compile_cache_dir", type=str, default="",
                    help="the JAX package's compilation cache; the port "
                         "compiles no programs per run, so it is ignored")
    args = ap.parse_args(argv)

    from transformer_clip_eeg_tpu_torch.models.heads import embedding_width
    from transformer_clip_eeg_tpu_torch.serve import InferenceSession, RetrievalIndex

    session = InferenceSession.from_results_dir(args.results_folder, chunk=args.chunk,
                                                device=device)
    index = None
    if args.candidates:
        emb = session.embed_speech(np.load(args.candidates).astype(np.float32))
        capacity = args.capacity or max(1024, 2 * emb.shape[0])
        index = RetrievalIndex(emb.shape[1], capacity=capacity, device=device)
        index.add(emb)
        print(f"retrieval index: {emb.shape[0]} candidates (capacity {capacity})")
    elif args.capacity:
        dim = embedding_width(session.model.eegModel, session.cfg.window_length)
        index = RetrievalIndex(dim, capacity=args.capacity, device=device)

    cfg = session.cfg
    service = EmbeddingService(
        session, index,
        info={"model_arch": cfg.model_arch, "eeg_encoder": cfg.eeg_encoder,
              "speech_encoder": cfg.speech_encoder, "window_length": cfg.window_length},
        batch_window_ms=args.batch_window_ms,
    )
    httpd = make_server(service, args.host, args.port)
    print(f"serving {args.results_folder} on http://{args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
