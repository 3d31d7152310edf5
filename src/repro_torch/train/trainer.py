"""The training loop with checkpoint/restart and the straggler watchdog.

Beyond calling the step function:
  * checkpoint/restart: resumes from the latest committed checkpoint; data
    is step-indexed, so a restart is bit-deterministic (no iterator state).
  * async checkpointing every ``ckpt_every`` steps (the device-to-host copy
    before the step goes on, the file writes on a worker thread).
  * straggler/hang watchdog: a step that takes more than
    ``watchdog_factor`` x the trailing-median step time is flagged (on a
    cluster that would requeue or replace the slow host; here it logs).
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.ckpt import Checkpointer, tree_leaves
from repro_torch.data import pipeline as data_pipeline


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    watchdog_factor: float = 3.0
    log_every: int = 10


@dataclass
class StepTimer:
    history: list[float] = field(default_factory=list)
    flagged: list[int] = field(default_factory=list)

    def record(self, step: int, dt: float, factor: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.history) >= 5:
            med = statistics.median(self.history[-20:])
            if dt > factor * med:
                self.flagged.append(step)
                is_straggler = True
        self.history.append(dt)
        return is_straggler


def _synchronize(tree) -> None:
    """Wait for the card that holds ``tree``'s tensors (nothing on the CPU)."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def train(
    state,
    step_fn,
    data_cfg: data_pipeline.DataConfig,
    tcfg: TrainerConfig,
    *,
    start_step: int = 0,
    log=print,
    clock=time.perf_counter,
):
    """Run ``step_fn(state, batch) -> (state, metrics)`` from ``start_step``
    to ``tcfg.total_steps``; returns ``(state, {"losses", "stragglers"})``.
    ``clock`` (seconds, monotonic) times each step for the watchdog."""
    ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
    timer = StepTimer()
    losses = []
    step = start_step
    while step < tcfg.total_steps:
        batch = data_pipeline.get_batch(data_cfg, step)
        t0 = clock()
        state, metrics = step_fn(state, batch)
        _synchronize(metrics)
        dt = clock() - t0
        if timer.record(step, dt, tcfg.watchdog_factor):
            log(f"[straggler] step {step} took {dt:.3f}s (median "
                f"{statistics.median(timer.history[-20:]):.3f}s) — would requeue host")
        losses.append(float(metrics["loss"]))
        if step % tcfg.log_every == 0:
            log(f"step {step} loss {losses[-1]:.4f} ({dt*1e3:.0f} ms)")
        step += 1
        if step % tcfg.ckpt_every == 0 or step == tcfg.total_steps:
            ckpt.save_async(step, {"state": state})
    ckpt.wait()
    return state, {"losses": losses, "stragglers": timer.flagged}


def resume(like_state, tcfg: TrainerConfig, shardings=None):
    """Restore the latest checkpoint into ``like_state``'s structure, dtypes
    and devices; ``(None, 0)`` on a fresh start.  ``shardings`` (the state's
    NamedShardings, ``train_step.state_shardings``): ``like_state`` holds
    the global shapes and this rank gets its slices, on whatever mesh."""
    ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
    step = ckpt.latest_step()
    if step is None:
        return None, 0
    restored, step = ckpt.restore({"state": like_state}, shardings=(
        None if shardings is None else {"state": shardings}))
    return restored["state"], step
