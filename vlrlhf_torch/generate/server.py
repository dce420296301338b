"""Live serving daemon (counterpart of vlrlhf_tpu/generate/server.py): a
scheduler thread drives ContinuousEngine.serve() from a thread-safe source,
so requests from concurrent HTTP clients admit into cache slots as soon as
one frees.

  QueueSource    — source protocol over a deque + condition variable
  EngineServer   — owns the scheduler thread; submit(Request) -> Future
  RequestBuilder — question + image (+ adapter index) -> engine Request
  ChatBackend    — multi-turn sessions: one ChatSession (its own live
                   cache) per session id, LRU-capped
  EndpointRunner — the eval harness's runner over HTTP: run_vqa posts
                   /generate from a thread pool, run_vqa_ppl posts /score
  serve_http     — stdlib ThreadingHTTPServer: POST /generate
                   {"question", "image"?, "max_new_tokens"?, "stream"?,
                   "adapter"?} -> {"text", "tokens"} ("adapter" names one
                   of the engine's registered sets; an unknown name answers
                   400 with the registered names; without it the base model
                   decodes), POST /chat {"message", "session_id"?,
                   "image"?} -> {"text", "session_id"}, POST /score {"rows":
                   [{"question", "answer", "image"?}]} -> {"ppl": [...]}
                   (the mean CE of each answer, eval/harness.py
                   run_vqa_ppl behind a lock), GET /health, GET /metrics.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np
import torch

from vlrlhf_torch.data.collators import GenerationCollator
from vlrlhf_torch.data.processor import make_single_turn_conv
from vlrlhf_torch.generate.continuous import ContinuousEngine, Request
from vlrlhf_torch.generate.engine import ChatSession, GenerateConfig, Generator


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
        adapter_idx: Optional[int] = None,
    ) -> Request:
        proc = self.processor
        n_img = 0 if img_path is None else 1
        prompt = proc.format_multimodal_prompt(question, n_img)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        ids = proc.maybe_prefix_image_ids(ids, n_img)
        b = self.collator([{"input_ids": ids, "img_path": img_path}])
        plen = int(b["prompt_lens"][0])
        has_img = img_path is not None
        return Request(
            input_ids=np.asarray(b["input_ids"][0, :plen]),
            pixel_values=b["pixel_values"][0, 0] if has_img else None,
            image_positions=np.asarray(b["image_positions"][0]) if has_img else None,
            max_new_tokens=max_new_tokens,
            adapter_idx=adapter_idx,
        )


class ChatBackend:
    """Multi-turn /chat sessions over ChatSession (vlrlhf_tpu ChatBackend,
    server.py:258-354): each turn chunk-prefills into the session's live
    cache instead of re-prefilling the conversation.

    One cache of cache_len slots per session, LRU-capped at max_sessions
    (at 7B a 1024-slot cache is 0.5 GiB bf16, 0.27 GiB int8). Turn N+1's
    tokens are the template delta `assistant_end + user_begin + message +
    user_end + assistant_begin`, tokenized alone; the previous response's
    stop token leads it, since the decode loop never wrote that token's
    kv. One chat operation runs at a time; the sessions share one
    Generator (and the engine's model)."""

    def __init__(
        self,
        model,
        processor,
        collator_cfg,
        gen_cfg: GenerateConfig,
        cache_len: int = 1024,
        max_sessions: int = 4,
        image_loader=None,
        generator: Optional[torch.Generator] = None,
    ):
        self.processor = processor
        self.template = processor.template
        self.gen_cfg = gen_cfg
        self.cache_len = cache_len
        self.max_sessions = max_sessions
        self._gen = Generator(model, gen_cfg)
        self._collator = GenerationCollator(processor, collator_cfg, image_loader)
        self._generator = generator
        self._sessions: OrderedDict[str, ChatSession] = OrderedDict()
        self._lock = threading.Lock()
        self._counter = 0

    def _strip(self, row) -> str:
        stop = {int(t) for t in (self.gen_cfg.eos_token_ids or ())}
        stop.add(int(self.gen_cfg.pad_token_id))
        keep = []
        for t in np.asarray(row).tolist():
            if int(t) in stop:
                break
            keep.append(int(t))
        return self.processor.tokenizer.decode(keep, skip_special_tokens=True).strip()

    def chat(self, message: str, session_id: Optional[str] = None,
             image: Optional[str] = None) -> tuple[str, str]:
        """Returns (response text, session id)."""
        with self._lock:
            proc = self.processor
            if session_id is None or session_id not in self._sessions:
                self._counter += 1
                session_id = session_id or f"s{self._counter}"
                n_img = 0 if image is None else 1
                prompt = proc.format_multimodal_prompt(message, n_img)
                ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
                batch = self._collator([{"input_ids": ids, "img_path": image}])
                sess = ChatSession(self._gen, cache_len=self.cache_len)
                out = sess.start(batch, self._generator)
                self._sessions[session_id] = sess
                while len(self._sessions) > self.max_sessions:
                    self._sessions.popitem(last=False)  # LRU evict
            else:
                sess = self._sessions.pop(session_id)
                self._sessions[session_id] = sess  # most recently used
                t = self.template
                delta = t.assistant_end + t.user_begin + message + t.user_end + t.assistant_begin
                ids = proc.tokenizer.encode(delta, add_special_tokens=False)
                out = sess.extend(np.asarray([ids], np.int32),
                                  np.asarray([len(ids)], np.int32), self._generator)
            return self._strip(out[0].cpu()), session_id


class EndpointRunner:
    """The eval harness's runner against a `serve` daemon over HTTP
    (vlrlhf_tpu EndpointRunner, server.py:357-428; the reference's remote
    run_vqa_sgl): run_vqa posts each row to /generate from `num_threads`
    threads, run_vqa_ppl posts batches of rows to /score. The model lives
    in the serving process."""

    def __init__(self, endpoint: str, num_threads: int = 32, timeout: float = 600.0):
        self.endpoint = endpoint.rstrip("/")
        self.num_threads = num_threads
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(self.endpoint + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            out = json.loads(r.read())
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def run_vqa(self, rows, batch_size: int = 16, prompt_key: str = "question",
                image_key: str = "img", progress: bool = False) -> list[dict]:
        from concurrent.futures import ThreadPoolExecutor

        rows = [dict(r) for r in rows]
        with ThreadPoolExecutor(self.num_threads) as ex:
            texts = list(ex.map(lambda r: self._post("/generate", {
                "question": r[prompt_key], "image": r.get(image_key)})["text"], rows))
        for r, t in zip(rows, texts):
            r["response"] = t
        return rows

    def run_vqa_ppl(self, rows, batch_size: int = 16, prompt_key: str = "question",
                    answer_key: str = "answer", image_key: str = "img",
                    progress: bool = False) -> list[dict]:
        rows = [dict(r) for r in rows]
        for start in range(0, len(rows), batch_size):
            chunk = rows[start: start + batch_size]
            res = self._post("/score", {"rows": [
                {"question": r[prompt_key], "answer": r[answer_key], "image": r.get(image_key)}
                for r in chunk]})
            for row, ppl in zip(chunk, res["ppl"]):
                row["ppl"] = float(ppl)
        return rows


def serve_http(
    server: EngineServer,
    builder: RequestBuilder,
    tokenizer,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout: float = 600.0,
    chat: Optional[ChatBackend] = None,
    scorer=None,  # callable(rows) -> rows with "ppl": /score (EvalRunner.run_vqa_ppl)
    adapter_names: Optional[list] = None,  # "adapter" name -> Request.adapter_idx
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
            if self.path == "/score":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if scorer is None:
                        self._json(400, {"error": "scoring disabled"})
                        return
                    if not isinstance(body.get("rows"), list):
                        self._json(400, {"error": 'expected {"rows": [{"question", "answer", '
                                                  '"image"?}, ...]}'})
                        return
                    scored = scorer([{"question": r["question"], "answer": r["answer"],
                                      "img": r.get("image")} for r in body["rows"]])
                    self._json(200, {"ppl": [r["ppl"] for r in scored]})
                except Exception as e:  # noqa: BLE001 — report to the client
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path == "/chat":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if chat is None:
                        self._json(400, {"error": "chat sessions disabled (--chat_sessions 0)"})
                        return
                    text, sid = chat.chat(body["message"], body.get("session_id"),
                                          body.get("image"))
                    self._json(200, {"text": text, "session_id": sid})
                except Exception as e:  # noqa: BLE001 — report to the client
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                aidx = None
                if body.get("adapter") is not None:
                    if not adapter_names or body["adapter"] not in adapter_names:
                        self._json(400, {"error": f"unknown adapter {body['adapter']!r}; "
                                                  f"registered: {adapter_names or []}"})
                        return
                    aidx = adapter_names.index(body["adapter"])
                req = builder.build(body["question"], body.get("image"),
                                    body.get("max_new_tokens"), adapter_idx=aidx)
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
