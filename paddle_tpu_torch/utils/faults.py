"""Serving error types (the subset of ``paddle_tpu/utils/faults.py`` the
paged engine raises; the fault-injection registry comes with the serving
slice)."""


class BackpressureError(RuntimeError):
    """Serving admission queue at capacity: the request was rejected
    immediately rather than queued (the caller should back off/shed)."""
