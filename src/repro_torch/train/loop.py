"""Fault-tolerant training loop (``repro/train/loop.py``).

- crash recovery: restores the latest checkpoint on start;
- periodic and preemption-signal-triggered (SIGTERM) atomic checkpoints;
- bounded retry of transient step failures (``RuntimeError``, which
  covers PyTorch's and CUDA's errors);
- straggler mitigation: the data iterator is wrapped in a prefetch thread
  with a per-batch deadline; a slow batch is replaced by the last one
  (the spare) and counted, instead of stalling the step.

Where the JAX package waits with ``jax.block_until_ready``, the loop reads
the loss with ``.item()``, which waits for the card.
"""
from __future__ import annotations

import logging
import queue
import signal
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Union

import torch

from . import checkpoint

log = logging.getLogger("repro_torch.train")


class PrefetchIterator:
    """Background-thread prefetch with a per-batch deadline."""

    def __init__(self, it: Iterator, depth: int = 2, deadline_s: float = 30.0):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._deadline = deadline_s
        self._spare = None
        self.skipped = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._deadline)
        except queue.Empty:
            if self._spare is not None:
                self.skipped += 1
                log.warning("data deadline exceeded; reusing spare batch (straggler skip)")
                return self._spare
            raise StopIteration from None
        if item is None:
            raise StopIteration
        self._spare = item
        return item


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,
        state: Any,
        data: Iterator,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        max_step_retries: int = 2,
        device: Optional[Union[str, torch.device]] = None,
        state_shardings: Any = None,
        deadline_s: float = 30.0,
        fault_hook: Optional[Callable[[int], None]] = None,  # test injection
    ):
        self.train_step = train_step
        self.state = state
        self.data = PrefetchIterator(iter(data), deadline_s=deadline_s)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_step_retries = max_step_retries
        self.device = device
        self.state_shardings = state_shardings
        self.fault_hook = fault_hook
        self.metrics_history = []
        self._preempted = False

    # ---- fault tolerance plumbing ----
    def install_signal_handler(self, sig=signal.SIGTERM):
        def handler(signum, frame):
            log.warning("preemption signal received; checkpointing at next step")
            self._preempted = True

        signal.signal(sig, handler)

    def maybe_restore(self):
        if self.ckpt_dir and checkpoint.latest_step(self.ckpt_dir) is not None:
            step = checkpoint.latest_step(self.ckpt_dir)
            log.info("restoring checkpoint step %s", step)
            self.state = checkpoint.restore(self.ckpt_dir, self.state, step=step,
                                            device=self.device,
                                            shardings=self.state_shardings)
            return step
        return None

    def _checkpoint(self):
        if self.ckpt_dir:
            checkpoint.save(self.state, self.ckpt_dir, int(self.state["step"]))
            checkpoint.prune(self.ckpt_dir)

    # ---- the loop ----
    def run(self, num_steps: int) -> Dict:
        self.maybe_restore()
        start = int(self.state["step"])
        for i, batch in enumerate(self.data):
            step_no = start + i
            if step_no >= num_steps:
                break
            attempt = 0
            while True:
                try:
                    if self.fault_hook:
                        self.fault_hook(step_no)
                    self.state, metrics = self.train_step(self.state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the card
                    break
                except RuntimeError as e:
                    attempt += 1
                    if attempt > self.max_step_retries:
                        log.error("step %s failed %s times; checkpoint + raise", step_no, attempt)
                        self._checkpoint()
                        raise
                    log.warning("step %s attempt %s failed (%s); retrying", step_no, attempt, e)
            self.metrics_history.append(metrics)
            if self._preempted or (self.ckpt_every and (step_no + 1) % self.ckpt_every == 0):
                self._checkpoint()
                if self._preempted:
                    log.warning("exiting after preemption checkpoint")
                    break
        if self.ckpt_dir:
            self._checkpoint()
        return {
            "final_step": int(self.state["step"]),
            "stragglers_skipped": self.data.skipped,
            "metrics": self.metrics_history,
        }
