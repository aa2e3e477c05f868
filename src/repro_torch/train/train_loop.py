"""Fault-tolerant training loop: checkpoint and restart, retries, straggler
deadlines, a JSONL log.  The counterpart of `repro.train.train_loop`
(`LoopConfig`, `TrainLoop`).

The loop is host-side and simple: ALL numerics live in `step_fn`; the
loop moves batches, enforces deadlines, checkpoints and recovers.

* **restart**: on construction the loop restores the newest *valid*
  checkpoint onto its device (damaged ones are skipped by crc) and seeks
  the data stream to that step, so training resumes exactly where it left.
* **step failure** (a worker exception): the step is retried up to
  `max_retries` times from the last good state; past that, the loop
  restores the last checkpoint and goes on.
* **straggler deadline**: each step has a wall-clock budget
  (`deadline_factor` × the rolling median); breaches are logged and counted.

A step's time ends at a CUDA synchronize of the new state's device (the
reference blocks on the state's first leaf).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    max_retries: int = 2
    deadline_factor: float = 5.0   # × rolling median step time
    log_path: Optional[str] = None


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,           # (state, batch) -> (state, metrics)
        init_state: Any,
        stream,                      # has .batch_at(step)
        cfg: LoopConfig,
        to_device: Optional[Callable] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        """`to_device` maps a host batch to what `step_fn` takes; by default
        each numpy array of the batch becomes a tensor on `device`, where
        checkpoints are restored too."""
        self.step_fn = step_fn
        self.stream = stream
        self.cfg = cfg
        self.device = resolve_device(device)
        self.to_device = self._batch_to_device if to_device is None else to_device
        self.step_times: list = []
        self.straggler_events = 0
        self.recoveries = 0

        restored_step, restored = ckpt.restore_latest(cfg.ckpt_dir, device=self.device)
        if restored is not None:
            self.state = restored
            self.start_step = restored_step + 1
        else:
            self.state = init_state
            self.start_step = 0

    # -- internals ----------------------------------------------------------

    def _batch_to_device(self, batch: Any) -> Any:
        return T.tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device),
                          batch)

    @staticmethod
    def _sync(state: Any) -> None:
        for leaf in T.leaves(state):
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                return

    def _deadline(self) -> Optional[float]:
        if len(self.step_times) < 5:
            return None
        return float(np.median(self.step_times[-20:]) * self.cfg.deadline_factor)

    def _log(self, record: dict) -> None:
        if self.cfg.log_path:
            with open(self.cfg.log_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _checkpoint(self, step: int) -> None:
        ckpt.save(self.cfg.ckpt_dir, step, self.state)
        ckpt.garbage_collect(self.cfg.ckpt_dir, keep=self.cfg.keep_checkpoints)

    # -- main entry ----------------------------------------------------------

    def run(self, n_steps: int, fail_hook: Optional[Callable] = None) -> dict:
        """Run up to global step `start_step + n_steps`.

        fail_hook(step) may raise to simulate node failures (the tests use
        it to drive the retry and restore path).
        """
        last_metrics: dict = {}
        for step in range(self.start_step, self.start_step + n_steps):
            batch = self.to_device(self.stream.batch_at(step))
            attempt = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if fail_hook is not None:
                        fail_hook(step)
                    new_state, metrics = self.step_fn(self.state, batch)
                    self._sync(new_state)
                    break
                except ckpt.CorruptCheckpoint:
                    raise
                except Exception as e:  # noqa: BLE001 — worker failure path
                    attempt += 1
                    self.recoveries += 1
                    if attempt <= self.cfg.max_retries:
                        self._log(dict(step=step, event="retry", error=repr(e)))
                        continue
                    # hard failure: restore the last good checkpoint and go on
                    _, restored = ckpt.restore_latest(self.cfg.ckpt_dir, device=self.device)
                    self._log(dict(step=step, event="restore", error=repr(e)))
                    if restored is not None:
                        self.state = restored
                    attempt = 0
                    if fail_hook is not None:
                        fail_hook = None  # the "node" has been replaced
            dt = time.perf_counter() - t0
            deadline = self._deadline()
            if deadline is not None and dt > deadline:
                self.straggler_events += 1
                self._log(dict(step=step, event="straggler", dt=dt, deadline=deadline))
            self.step_times.append(dt)
            self.state = new_state
            last_metrics = {k: float(v) for k, v in metrics.items()}
            self._log(dict(step=step, dt=dt, **last_metrics))
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self._checkpoint(step)
        final_step = self.start_step + n_steps - 1
        self._checkpoint(final_step)
        return dict(
            final_step=final_step,
            metrics=last_metrics,
            stragglers=self.straggler_events,
            recoveries=self.recoveries,
        )
