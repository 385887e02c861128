"""The asyncio HTTP front end of the scoring service (the JAX package's
``serve/server.py``).

Stdlib only (asyncio streams + a minimal HTTP/1.1 parser).  Endpoints:

  POST /v1/predict   {"instances": [[...]]} | {"b64": ..., "shape": [...]}
                     -> {"round", "predictions": [{"pred", "confidence",
                         "margin"}]}
  POST /v1/score     same request schema (+ optional "embedding": true)
                     -> {"round", "scores": [{"pred", "confidence",
                         "margin", "entropy"}], "embedding"?: [[...]]}
  GET  /healthz      liveness + the served round, bucket ladder, and
                     image shape
  GET  /metrics      ServeMetrics snapshot + executor/batcher state and
                     the launch counts of the port's kernels (the JAX
                     server's jit compile counters have no counterpart
                     here).  JSON only: ``?format=prometheus`` and
                     ``/v1/profile`` come in a later slice.

Backpressure is explicit: when admission would exceed ``queue_depth``
rows the server answers **429 with Retry-After**; a request larger than
``queue_depth`` rows is a non-retryable **413**; during drain new work
gets **503**.

Graceful drain (SIGTERM): stop accepting connections, let the batcher
flush and every admitted request complete, stop the executor, exit 0.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
from typing import Dict, Optional, Tuple

import numpy as np

from .batcher import BatcherClosedError, MicroBatcher, QueueFullError
from .executor import DeviceExecutor, kernel_launches
from .metrics import ServeMetrics
from ..config import ServeConfig
from ..utils.logging import get_logger

MAX_BODY_BYTES = 256 << 20  # one request can carry a full max_batch of 224px


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


class ScoringServer:
    def __init__(self, executor: DeviceExecutor, cfg: ServeConfig,
                 metrics: Optional[ServeMetrics] = None):
        self.executor = executor
        self.cfg = cfg
        self.metrics = metrics or ServeMetrics()
        self.logger = get_logger()
        self.batcher: Optional[MicroBatcher] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._draining = False
        self.port: Optional[int] = None

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        """Warm every bucket, start the executor threads and the batcher,
        then open the listener."""
        self.batcher = MicroBatcher(
            dispatch=self.executor.submit_batch,
            max_batch=self.cfg.max_batch,
            max_latency_ms=self.cfg.max_latency_ms,
            queue_depth=self.cfg.queue_depth,
            bucket_floor=self.cfg.bucket_floor,
            on_batch=self.metrics.record_batch,
        )
        self.executor.warmup(self.batcher.buckets)
        self.executor.start()
        self.batcher.start()
        self._server = await asyncio.start_server(
            self._client, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.logger.info(
            f"serve: listening on http://{self.cfg.host}:{self.port} "
            f"(buckets {self.batcher.buckets}, round "
            f"{self.executor.served_round})")

    async def drain(self) -> None:
        """SIGTERM path: close the listener, complete everything
        admitted, stop the device loop."""
        if self._draining:
            return
        self._draining = True
        self.logger.info("serve: drain started (SIGTERM)")
        if self._server is not None:
            self._server.close()
        try:
            await self.batcher.drain(timeout_s=self.cfg.drain_timeout_s)
        finally:
            # The executor stops AFTER the batcher's queue emptied: its
            # shutdown sentinel is FIFO behind every flushed batch.
            await asyncio.get_running_loop().run_in_executor(
                None, self.executor.stop)
        if self._server is not None:
            await self._server.wait_closed()
        self.logger.info("serve: drained cleanly")

    # -- connection handling ---------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _HttpError as e:
                    # A malformed head has no trustworthy framing left:
                    # answer and close.
                    _write_response(writer, e.status, {"error": e.message},
                                    e.headers, keep_alive=False)
                    await writer.drain()
                    break
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if req is None:
                    break
                method, path, headers, body = req
                loop = asyncio.get_running_loop()
                t0 = loop.time()
                status, payload, extra = await self._route(method, path,
                                                           body)
                rows = payload.pop("__rows__", 0) if isinstance(
                    payload, dict) else 0
                self.metrics.record_response(
                    status, loop.time() - t0 if method == "POST" else None,
                    rows=rows)
                keep = (headers.get("connection", "").lower()
                        != "close") and not self._draining
                try:
                    _write_response(writer, status, payload, extra,
                                    keep_alive=keep)
                    await writer.drain()
                except (ConnectionError, OSError):
                    # The peer vanished mid-response (churny clients,
                    # LB probes): a silent close, not an unhandled-task
                    # traceback per disconnect.
                    break
                if not keep:
                    break
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001 - peer may already be gone
                pass

    async def _route(self, method: str, path: str, body: bytes
                     ) -> Tuple[int, Dict, Dict[str, str]]:
        path, _, query = path.partition("?")
        try:
            if method == "GET" and path == "/healthz":
                return 200, self._healthz(), {}
            if method == "GET" and path == "/metrics":
                from urllib.parse import parse_qs
                fmt = (parse_qs(query).get("format") or [""])[0]
                if fmt and fmt != "json":
                    raise _HttpError(400, f"unknown metrics format "
                                          f"{fmt!r}; this server speaks "
                                          "json")
                return 200, self._metrics(), {}
            if method == "POST" and path in ("/v1/predict", "/v1/score"):
                self.metrics.record_request(path)
                if self._draining:
                    raise _HttpError(503, "server is draining")
                return await self._score(path, body)
            raise _HttpError(404, f"no route for {method} {path}")
        except _HttpError as e:
            return e.status, {"error": e.message}, e.headers
        except (QueueFullError,) as e:
            # Explicit backpressure: bounded admission, never unbounded
            # queueing.  Retry-After 1s: one max_latency window plus the
            # device's worst-case batch is well under a second.
            return 429, {"error": str(e)}, {"Retry-After": "1"}
        except BatcherClosedError as e:
            return 503, {"error": str(e)}, {}
        except Exception as e:  # noqa: BLE001 - request isolation
            self.logger.exception("serve: request failed")
            return 500, {"error": repr(e)}, {}

    # -- endpoints --------------------------------------------------------

    async def _score(self, path: str, body: bytes
                     ) -> Tuple[int, Dict, Dict[str, str]]:
        req = _parse_json(body)
        images = _decode_images(req, self.executor.image_shape)
        if images.shape[0] > self.cfg.queue_depth:
            # Permanently inadmissible (it could never fit the row
            # bound even on an idle server): a non-retryable 413, not a
            # 429 that compliant clients would retry forever.
            raise _HttpError(
                413, f"request of {images.shape[0]} rows exceeds the "
                     f"server's queue_depth={self.cfg.queue_depth}; "
                     "split the request")
        want_embed = bool(req.get("embedding")) and path == "/v1/score"
        out = await self.batcher.submit(images, want_embed=want_embed)
        rnd = int(out.get("round", self.executor.served_round))
        n = images.shape[0]
        if path == "/v1/predict":
            rows = [{"pred": int(out["pred"][i]),
                     "confidence": float(out["confidence"][i]),
                     "margin": float(out["margin"][i])}
                    for i in range(n)]
            return 200, {"round": rnd, "predictions": rows,
                         "__rows__": n}, {}
        rows = [{"pred": int(out["pred"][i]),
                 "confidence": float(out["confidence"][i]),
                 "margin": float(out["margin"][i]),
                 "entropy": float(out["entropy"][i])}
                for i in range(n)]
        resp: Dict = {"round": rnd, "scores": rows, "__rows__": n}
        if want_embed:
            # tolist() does the whole conversion in C; a Python float()
            # loop here would block the event loop (and the batcher's
            # deadline timer) for n*D calls per request.
            resp["embedding"] = np.asarray(
                out["embedding"], dtype=np.float64).tolist()
        return 200, resp, {}

    def _healthz(self) -> Dict:
        return {
            "ok": True,
            "round": self.executor.served_round,
            "image_shape": list(self.executor.image_shape),
            "buckets": list(self.batcher.buckets),
            "max_batch": self.cfg.max_batch,
            "draining": self._draining,
        }

    def _metrics(self) -> Dict:
        snap = self.metrics.snapshot()
        with self.executor._lock:
            ex = dict(self.executor.stats)
        snap["executor"] = ex
        snap["served_round"] = self.executor.served_round
        snap["queue"] = {
            "pending_rows": self.batcher.pending_rows,
            "depth": self.cfg.queue_depth,
        }
        snap["kernels"] = {"launches": kernel_launches()}
        # The live score histogram + drift against the previous
        # checkpoint (telemetry/diagnostics.ServeScoreDrift); getattr:
        # stub executors carry no drift tracker.
        drift = getattr(self.executor, "score_drift", None)
        if drift is not None:
            snap["score_drift"] = drift.snapshot()
        return snap


# -- wire helpers ------------------------------------------------------------

async def _read_request(reader: asyncio.StreamReader):
    """One HTTP/1.1 request -> (method, path, headers, body); None on a
    cleanly closed connection."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise _HttpError(400, f"malformed request line {lines[0]!r}")
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise _HttpError(400, "malformed Content-Length")
    if length < 0:
        raise _HttpError(400, "malformed Content-Length")
    if length > MAX_BODY_BYTES:
        raise _HttpError(413, f"body of {length} bytes exceeds "
                              f"{MAX_BODY_BYTES}")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, headers, body


def _write_response(writer: asyncio.StreamWriter, status: int,
                    payload: Dict, extra_headers: Dict[str, str],
                    keep_alive: bool) -> None:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              413: "Payload Too Large", 429: "Too Many Requests",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "")
    body = json.dumps(payload).encode()
    head = [f"HTTP/1.1 {status} {reason}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    head += [f"{k}: {v}" for k, v in extra_headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)


def _parse_json(body: bytes) -> Dict:
    try:
        req = json.loads(body.decode() or "{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise _HttpError(400, f"invalid JSON body: {e}")
    if not isinstance(req, dict):
        raise _HttpError(400, "body must be a JSON object")
    return req


def _decode_images(req: Dict, image_shape) -> np.ndarray:
    """{"instances": nested lists} or {"b64": ..., "shape": [n,h,w,c]}
    -> uint8 [n, H, W, C], validated against the served model's input
    shape at the door."""
    h, w, c = image_shape
    if "b64" in req:
        shape = req.get("shape")
        # Every entry must be a true non-negative JSON integer — floats
        # or digit strings would survive the len check only to blow up
        # in reshape as a 500; a malformed request is a 400.
        if (not isinstance(shape, (list, tuple)) or len(shape) != 4
                or not all(isinstance(d, int)
                           and not isinstance(d, bool)
                           and d >= 0 for d in shape)):
            raise _HttpError(400, "b64 payloads need shape [n, h, w, c] "
                                  "of non-negative integers")
        try:
            raw = base64.b64decode(req["b64"], validate=True)
        except (binascii.Error, TypeError, ValueError) as e:
            raise _HttpError(400, f"invalid base64 payload: {e}")
        n = int(shape[0])
        if n <= 0:
            raise _HttpError(400, "empty request")
        if len(raw) != int(np.prod(shape)):
            raise _HttpError(400, f"payload of {len(raw)} bytes does not "
                                  f"match shape {list(shape)}")
        images = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    elif "instances" in req:
        try:
            images = np.asarray(req["instances"], dtype=np.uint8)
        except (ValueError, TypeError) as e:
            raise _HttpError(400, f"invalid instances payload: {e}")
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[0] == 0:
            raise _HttpError(400, "instances must be [n, h, w, c] uint8")
    else:
        raise _HttpError(400, "body needs 'instances' or 'b64'+'shape'")
    if tuple(images.shape[1:]) != (h, w, c):
        raise _HttpError(
            400, f"rows of shape {list(images.shape[1:])} do not match "
                 f"the served model's input {[h, w, c]}")
    return np.ascontiguousarray(images)
