"""Progress of a pass (the counterpart of ``vaex_tpu/progress.py``).

The executor emits ``signal_progress`` once per tile with the fraction of
the pass's rows done; a callback that returns ``False`` cancels the pass,
whose tasks then reject with :class:`~.execution.UserAbort`.  A
``progress=`` argument takes True or ``"simple"`` (a bar on stderr), a
callable, or None.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    """A one-line bar with the elapsed time and an estimate of the rest."""

    def __init__(self, title="vaex_tpu_torch", out=sys.stderr, width=40):
        self.title = title
        self.out = out
        self.width = width
        self.start = time.time()
        self.last = 0.0

    def __call__(self, fraction):
        now = time.time()
        if fraction < 1.0 and now - self.last < 0.05:
            return True
        self.last = now
        filled = int(self.width * min(fraction, 1.0))
        bar_text = "#" * filled + "-" * (self.width - filled)
        elapsed = now - self.start
        eta = elapsed / fraction * (1 - fraction) if fraction > 0 else 0
        self.out.write(f"\r{self.title} [{bar_text}] {fraction*100:6.2f}% "
                       f"elapsed {elapsed:6.2f}s eta {eta:6.2f}s")
        if fraction >= 1.0:
            self.out.write("\n")
        self.out.flush()
        return True


def bar(progress, title="vaex_tpu_torch"):
    """A ``progress=`` argument as a callable, or None."""
    if progress is None or progress is False:
        return None
    if progress is True or progress == "simple":
        return ProgressBar(title)
    if callable(progress):
        return progress
    return None


class scoped_progress:
    """Connects a ``progress=`` callback to an executor for a block."""

    def __init__(self, executor, progress, title="vaex_tpu_torch"):
        self.executor = executor
        self.callback = bar(progress, title)

    def __enter__(self):
        if self.callback is not None:
            self.executor.signal_progress.connect(self.callback)
        return self.callback

    def __exit__(self, *exc):
        if self.callback is not None and self.callback in self.executor.signal_progress.callbacks:
            self.executor.signal_progress.disconnect(self.callback)
        return False
