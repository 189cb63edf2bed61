"""Promise-lite + @delayed combinator (reference: vaex/promise.py, delayed.py).

The reference builds on the aplus Promise spec; here a minimal synchronous
promise is enough because a pass either completes or raises — async streaming
is handled by the executor itself.
"""

from __future__ import annotations


class Promise:
    def __init__(self):
        self.done = False
        self.result = None
        self.exception = None
        self._callbacks = []
        self._error_callbacks = []

    def fulfill(self, value):
        self.result = value
        self.done = True
        # a settled promise drops its callbacks: they close over the promises
        # they wait on, and the cycle would keep a pass's grids (GBs on a
        # card) alive until Python's cycle collector ran
        callbacks, self._callbacks, self._error_callbacks = self._callbacks, [], []
        for cb in callbacks:
            cb(value)
        return self

    def reject(self, exception):
        self.exception = exception
        self.done = True
        callbacks, self._callbacks, self._error_callbacks = self._error_callbacks, [], []
        for cb in callbacks:
            cb(exception)
        return self

    def then(self, cb, on_error=None):
        if self.done and self.exception is None:
            cb(self.result)
        elif self.done and self.exception is not None:
            if on_error is not None:
                on_error(self.exception)
        else:
            self._callbacks.append(cb)
            if on_error is not None:
                self._error_callbacks.append(on_error)
        return self

    def get(self):
        if self.exception is not None:
            raise self.exception
        if not self.done:
            raise RuntimeError("promise not resolved: the pass that computes it "
                               "did not run (or failed without rejecting it)")
        return self.result

    @staticmethod
    def all(promises):
        out = Promise()
        remaining = [len(promises)]
        results = [None] * len(promises)
        if not promises:
            return out.fulfill([])
        for i, p in enumerate(promises):
            def make(i):
                def cb(value):
                    results[i] = value
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        out.fulfill(results)
                return cb
            p.then(make(i))
        return out


def delayed(f):
    """Lift f over promises: result promise fulfilled once all args are
    (reference: delayed.py:29-77)."""

    def wrapped(*args, **kwargs):
        promises = [a for a in args if isinstance(a, Promise) or hasattr(a, "then")]
        out = Promise()

        def finish(_=None):
            rargs = [a.result if hasattr(a, "then") else a for a in args]
            rkwargs = {k: (v.result if hasattr(v, "then") else v) for k, v in kwargs.items()}
            out.fulfill(f(*rargs, **rkwargs))

        if not promises:
            finish()
        else:
            remaining = [len(promises)]

            def cb(_):
                remaining[0] -= 1
                if remaining[0] == 0:
                    finish()

            for p in promises:
                p.then(cb, on_error=out.reject)
        return out

    return wrapped
