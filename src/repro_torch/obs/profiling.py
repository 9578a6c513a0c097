"""Opt-in ``torch.profiler`` trace windows (the port of
``repro/obs/profiling.py``, which maps the same two shapes onto
``jax.profiler``).

* ``trace_window(log_dir)`` — context manager around one block of work
  (used by ``compress_model(profile_block=...)``); it yields whether the
  profiler started.
* ``StepTraceWindow(log_dir, steps)`` — start/step/stop object for wrapping
  the first N engine steps (used by ``serve.py --profile-steps``); its
  ``on_step`` method plugs into ``Engine.run(step_hook=...)`` and closes one
  ``ProfilerStep#N`` span a step, so each engine step is one span of the
  trace.

CPU activity is always recorded; CUDA activity (kernels, copies and
memsets, through CUPTI) whenever the process has initialised a CUDA
device. Shapes and stacks are not recorded. When a window ends, its trace
is written as Chrome-trace JSON to ``<log_dir>/block-<i>.trace.json``
(``trace_window``) or ``<log_dir>/steps-<i>.trace.json``
(``StepTraceWindow``), with ``i`` the first index not yet taken in that
directory.

Both are no-ops when the directory is empty. When the profiler cannot
start or write, one ``[obs]`` line goes to stderr and the work carries on
unprofiled, so telemetry never takes the serving path down; a caller that
needs the trace checks ``StepTraceWindow.path`` and the file's events.
Nothing here imports torch at module load.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys

__all__ = ["trace_window", "StepTraceWindow"]


def _record_every_step(step: int):
    from torch.profiler import ProfilerAction
    return ProfilerAction.RECORD


def _start(steps: bool):
    """A started ``torch.profiler.profile``, or None when it cannot start.
    With ``steps`` it marks ``ProfilerStep#N`` spans at each ``step()``."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       schedule=_record_every_step if steps else None)
        prof.start()
        return prof
    except Exception as e:  # environment dependent
        print(f"[obs] profiler start failed ({e!r}); continuing unprofiled",
              file=sys.stderr)
        return None


def _stop(prof, log_dir: str, name: str) -> str:
    """Stop ``prof`` and write its Chrome trace; the file's path, or "" when
    it could not be written."""
    try:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = next(p for p in (os.path.join(log_dir, f"{name}-{i}.trace.json")
                                for i in itertools.count())
                    if not os.path.exists(p))
        prof.export_chrome_trace(path)
        return path
    except Exception as e:  # environment dependent
        print(f"[obs] profiler stop failed ({e!r})", file=sys.stderr)
        return ""


@contextlib.contextmanager
def trace_window(log_dir: str):
    """Profile the enclosed block into ``log_dir``; no-op if dir is empty."""
    if not log_dir:
        yield False
        return
    prof = _start(steps=False)
    try:
        yield prof is not None
    finally:
        if prof is not None:
            _stop(prof, log_dir, "block")


class StepTraceWindow:
    """Profile the first ``steps`` engine steps after ``start()``; ``path``
    is the written trace once the window has ended ("" before, or when
    nothing could be written)."""

    def __init__(self, log_dir: str, steps: int):
        self.log_dir = log_dir
        self.steps = steps
        self.path = ""
        self._prof = None
        self._remaining = 0

    @property
    def enabled(self) -> bool:
        return bool(self.log_dir) and self.steps > 0

    @property
    def active(self) -> bool:
        """The profiler started and the window has not ended yet."""
        return self._prof is not None

    def start(self) -> None:
        if not self.enabled or self.active:
            return
        self._prof = _start(steps=True)
        self._remaining = self.steps

    def on_step(self, engine=None) -> None:
        if not self.active:
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self.stop()
        else:
            self._prof.step()

    def stop(self) -> None:
        if self.active:
            self.path = _stop(self._prof, self.log_dir, "steps")
            self._prof = None
