"""Straggler-tolerant, resumable input pipeline.

At 1000+ nodes the input tail matters: a slow/hung storage read must not
stall the step loop.  The Prefetcher keeps a bounded queue filled by a
background thread; ``next(timeout)`` falls back to SKIPPING the straggler
shard (it is re-queued at the end) after the deadline — the paper's Scribe
integration notes the same drop-under-pressure philosophy for log traffic.

Resumability: the cursor (next shard index, epoch) is part of the state dict
checkpointed with the model, so restarts are deterministic.  The port of
``repro.data.pipeline``: host threads only; what ``load_fn`` returns (the
port's shards are tensors on the store's device) is passed through as is.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Straggler(Exception):
    pass


class Prefetcher:
    def __init__(
        self,
        load_fn: Callable[[int], Any],
        shard_ids: List[int],
        *,
        depth: int = 2,
        start_cursor: int = 0,
        epoch: int = 0,
        inject_delay: Optional[Callable[[int], float]] = None,  # test hook
    ):
        self.load_fn = load_fn
        self.shard_ids = list(shard_ids)
        self.depth = depth
        self.cursor = start_cursor
        self.epoch = epoch
        self.skipped: List[int] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._inject_delay = inject_delay
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _worker(self) -> None:
        while not self._stop.is_set():
            idx = self.cursor % len(self.shard_ids)
            shard = self.shard_ids[idx]
            try:
                if self._inject_delay is not None:
                    time.sleep(self._inject_delay(shard))
                data = self.load_fn(shard)
            except Exception:  # damaged shard: skip it permanently
                self.skipped.append(shard)
                self.cursor += 1
                continue
            item = {"shard": shard, "cursor": self.cursor, "data": data}
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self.cursor += 1
            if self.cursor % len(self.shard_ids) == 0:
                self.epoch += 1

    # -------------------------------------------------------------- public
    def next(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Blocking get; on timeout raises Straggler (caller may retry with a
        longer deadline or synthesize/skip a batch)."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise Straggler(f"input pipeline stalled >{timeout}s") from None

    def state(self) -> dict:
        return {"cursor": self.cursor, "epoch": self.epoch, "skipped": list(self.skipped)}

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
