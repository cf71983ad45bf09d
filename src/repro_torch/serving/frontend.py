"""Request front end over `ServingEngine` (port of
`repro.serving.frontend`).

The engine is a synchronous step loop; the front end drives it from one
thread, so callers on any thread submit prompts and get back
`concurrent.futures.Future`s that resolve to the finished Request, or
raise RuntimeError when the engine rejects it. Every step, and so every
CUDA graph capture and replay, happens on the driver thread, which
makes the engine's device its current device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.engine import Request, ServingEngine


class ServingFrontend:
    """Thread-driving front end: `submit` is safe from any thread; the
    engine steps only on the driver thread."""

    def __init__(self, engine: ServingEngine, *, idle_sleep: float = 0.001):
        self.engine = engine
        self.idle_sleep = idle_sleep
        self._lock = threading.Lock()
        self._inbox: deque = deque()
        self._futures: dict[int, Future] = {}
        self._rid = 0
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0) -> Future:
        fut: Future = Future()
        with self._lock:
            rid = self._rid
            self._rid += 1
            req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens,
                          temperature=temperature)
            self._inbox.append(req)
            self._futures[rid] = fut
        return fut

    def _drain_inbox(self):
        with self._lock:
            reqs = list(self._inbox)
            self._inbox.clear()
        for req in reqs:
            self.engine.submit(req)

    def _resolve_done(self):
        done = []
        for lst, ok in ((self.engine.finished, True),
                        (self.engine.rejected, False)):
            for req in lst:
                fut = self._futures.pop(req.rid, None)
                if fut is None:
                    continue
                done.append((fut, req, ok))
        for fut, req, ok in done:
            if ok:
                fut.set_result(req)
            else:
                fut.set_exception(RuntimeError(f"rejected: {req.failed}"))

    def _loop(self):
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            while self._running:
                self._drain_inbox()
                progressed = self.engine.step()
                self._resolve_done()
                if not progressed:
                    time.sleep(self.idle_sleep)
        except Exception as exc:
            # a failed step fails every pending request instead of
            # leaving its caller waiting
            with self._lock:
                pending = list(self._futures.values())
                self._futures.clear()
            for fut in pending:
                fut.set_exception(exc)
            raise

    def close(self, timeout: Optional[float] = 10.0):
        self._running = False
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
