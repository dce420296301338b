"""Live serving daemon (counterpart of vlrlhf_tpu/generate/server.py): a
scheduler thread drives ContinuousEngine.serve() from a thread-safe source,
so requests from concurrent HTTP clients admit into cache slots as soon as
one frees.

  QueueSource    — source protocol over a deque + condition variable
  EngineServer   — owns the scheduler thread; submit(Request) -> Future
  RequestBuilder — question + image -> engine Request
  serve_http     — stdlib ThreadingHTTPServer: POST /generate
                   {"question", "image"?, "max_new_tokens"?, "stream"?} ->
                   {"text", "tokens"}, GET /health, GET /metrics. /score
                   and /chat answer 501 until their slice is ported.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np
import torch

from vlrlhf_torch.data.collators import GenerationCollator
from vlrlhf_torch.data.processor import make_single_turn_conv
from vlrlhf_torch.generate.continuous import ContinuousEngine, Request


class QueueSource:
    """Thread-safe request source for ContinuousEngine.serve()."""

    def __init__(self):
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def push(self, ridx: int, req: Request) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self._dq.append((ridx, req))
            self._cv.notify()

    def take(self):
        with self._cv:
            return self._dq.popleft() if self._dq else None

    def pending(self) -> int:
        with self._cv:
            return len(self._dq)

    def done(self) -> bool:
        with self._cv:
            return self._closed and not self._dq

    def wait(self) -> None:
        with self._cv:
            self._cv.wait_for(lambda: bool(self._dq) or self._closed, timeout=0.1)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class OverloadedError(RuntimeError):
    """Backpressure signal: the request queue is at max depth (HTTP 503)."""


class EngineServer:
    """Scheduler thread over a ContinuousEngine; submit() -> Future of the
    response token list."""

    def __init__(
        self,
        engine: ContinuousEngine,
        generator: Optional[torch.Generator] = None,
        max_queue: int = 256,
    ):
        self.engine = engine
        self._generator = generator
        self.max_queue = max_queue  # backpressure: refuse past this depth
        self._src = QueueSource()
        self._futures: dict[int, Future] = {}
        self._stream_cbs: dict[int, Any] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        self._done = 0
        self._tokens = 0
        self._dead: Optional[BaseException] = None

    def start(self) -> "EngineServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        try:
            self.engine.serve(
                self._src, self._finish, generator=self._generator,
                on_token=self._on_token,
            )
        except BaseException as e:  # noqa: BLE001 — fail pending futures, then re-raise
            with self._lock:
                # dead is set BEFORE the futures swap: a submit() racing the
                # liveness check is either in `futs` (failed below) or sees
                # _dead and raises, so no Future hangs a client forever
                self._dead = e
                futs, self._futures = self._futures, {}
            self._src.close()
            for f in futs.values():
                if not f.done():
                    f.set_exception(e)
            raise

    def _on_token(self, ridx: int, tok: int):
        cb = self._stream_cbs.get(ridx)
        if cb is not None:
            cb(tok)

    def _finish(self, ridx: int, tokens: list[int]):
        with self._lock:
            fut = self._futures.pop(ridx)
            self._stream_cbs.pop(ridx, None)
            self._done += 1
            self._tokens += len(tokens)
        fut.set_result(tokens)

    def stats(self) -> dict:
        with self._lock:
            dt = max(time.time() - self._t0, 1e-9)
            return {
                "requests_done": self._done,
                "requests_inflight": len(self._futures),
                "tokens_out": self._tokens,
                "tokens_per_sec": round(self._tokens / dt, 2),
                "uptime_s": round(dt, 1),
            }

    def submit(self, req: Request, on_token=None) -> Future:
        self.engine._check_fits(req)
        if self._src.pending() >= self.max_queue:
            raise OverloadedError(f"queue full ({self.max_queue} pending) — retry later")
        fut: Future = Future()
        with self._lock:
            if self._dead is not None:
                raise RuntimeError(f"engine scheduler died: {self._dead!r}") from self._dead
            ridx = self._next_id
            self._next_id += 1
            # registered BEFORE the scheduler can possibly take+finish it
            self._futures[ridx] = fut
            if on_token is not None:
                self._stream_cbs[ridx] = on_token
        try:
            self._src.push(ridx, req)
        except RuntimeError:
            with self._lock:
                self._futures.pop(ridx, None)
            raise
        return fut

    @property
    def alive(self) -> bool:
        return self._dead is None and (self._thread is not None and self._thread.is_alive())

    def stop(self, timeout: float = 30.0):
        self._src.close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)


class RequestBuilder:
    """question/image -> engine Request (prompt templating, image token
    expansion, pixel loading)."""

    def __init__(self, processor, collator_cfg, image_loader=None):
        self.processor = processor
        self.collator = GenerationCollator(processor, collator_cfg, image_loader)

    def build(
        self,
        question: str,
        img_path: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
    ) -> Request:
        proc = self.processor
        n_img = 0 if img_path is None else 1
        prompt = proc.format_multimodal_prompt(question, n_img)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        b = self.collator([{"input_ids": ids, "img_path": img_path}])
        plen = int(b["prompt_lens"][0])
        has_img = img_path is not None
        return Request(
            input_ids=np.asarray(b["input_ids"][0, :plen]),
            pixel_values=b["pixel_values"][0, 0] if has_img else None,
            image_positions=np.asarray(b["image_positions"][0]) if has_img else None,
            max_new_tokens=max_new_tokens,
        )


def serve_http(
    server: EngineServer,
    builder: RequestBuilder,
    tokenizer,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout: float = 600.0,
):
    """Blocking HTTP front-end. Returns the HTTPServer (call .shutdown()
    from another thread to stop); port=0 picks an ephemeral port
    (httpd.server_address[1])."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200 if server.alive else 500, {
                    "ok": server.alive,
                    "slots": server.engine.n_slots,
                    "cache_len": server.engine.cache_len,
                })
            elif self.path == "/metrics":
                self._json(200, server.stats())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path in ("/score", "/chat"):
                self._json(501, {"error": f"{self.path} is not ported yet"})
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                req = builder.build(
                    body["question"], body.get("image"), body.get("max_new_tokens")
                )
                if body.get("stream"):
                    self._stream(req)
                    return
                toks = server.submit(req).result(timeout=request_timeout)
                text = tokenizer.decode(list(toks), skip_special_tokens=True).strip()
                self._json(200, {"text": text, "tokens": len(toks)})
            except OverloadedError as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, req):
            """Server-sent events: text deltas as bursts land, then [DONE]."""
            tq: queue.Queue = queue.Queue()
            fut = server.submit(req, on_token=tq.put)
            fut.add_done_callback(lambda f: tq.put(None))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            ids: list[int] = []
            prev = ""
            while True:
                tok = tq.get(timeout=request_timeout)
                if tok is None:
                    break
                ids.append(int(tok))
                text = tokenizer.decode(ids, skip_special_tokens=True)
                delta, prev = text[len(prev):], text
                if delta:
                    self.wfile.write(f"data: {json.dumps({'delta': delta})}\n\n".encode())
                    self.wfile.flush()
            err = fut.exception()
            if err is not None:
                self.wfile.write(f"data: {json.dumps({'error': str(err)})}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")

    return ThreadingHTTPServer((host, port), Handler)
