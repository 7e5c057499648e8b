"""Asynchronous metric sending (Util/MetricSender.{h,cpp}): metrics go to
wandb from a background thread, so logging never blocks the training
loop; without wandb, or with ``use_wandb=False``, they are appended as
JSON lines to ``fallback_path`` (its folder made if missing).  The port's
own copy of the JAX package's module, with ``use_wandb`` added.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time


class MetricSender:
    def __init__(self, project: str = "Reinforcement Learning",
                 group: str = "Rocket League",
                 run_name: str = "rl-torch-run", run_id: str | None = None,
                 fallback_path: str = "metrics.jsonl",
                 use_wandb: bool = True):
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._wandb = None
        self._file = None
        if use_wandb:
            try:
                import wandb  # type: ignore
                self._run = wandb.init(project=project, group=group,
                                       name=run_name, id=run_id,
                                       resume="allow")
                self._wandb = wandb
            except Exception:
                self._wandb = None
        if self._wandb is None:
            folder = os.path.dirname(os.path.abspath(fallback_path))
            os.makedirs(folder, exist_ok=True)
            self._file = open(fallback_path, "a", buffering=1)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def run_id(self) -> str | None:
        if self._wandb is not None:
            return self._run.id
        return None

    def send(self, metrics: dict, step: int | None = None):
        """Queue metrics for the background thread
        (MetricSender.cpp:34-88)."""
        self._queue.put((dict(metrics), step, time.time()))

    def _worker(self):
        while not self._stop.is_set() or not self._queue.empty():
            try:
                metrics, step, ts = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                if self._wandb is not None:
                    self._wandb.log(metrics, step=step)
                else:
                    self._file.write(json.dumps(
                        {"time": ts, "step": step, **metrics}) + "\n")
            except Exception:
                pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self._wandb is not None:
            self._run.finish()
        if self._file is not None:
            self._file.close()
