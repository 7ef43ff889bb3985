"""Transient-failure resilience — a copy of ``acmgnn_tpu/utils/resilience.py``.

``retry_transient`` retries idempotent device work with exponential
backoff and re-raises at once on an error that is not transient.  The
markers are the JAX package's, unchanged.
"""

from __future__ import annotations

import functools
import time

TRANSIENT_MARKERS = (
    "remote_compile",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "RESOURCE_EXHAUSTED: Attempting to reserve",
    "response body closed",
    "Socket closed",
    "connection reset",
)


def is_transient(exc: BaseException) -> bool:
    msg = str(exc)
    return any(m.lower() in msg.lower() for m in TRANSIENT_MARKERS)


def retry_transient(fn=None, *, max_attempts: int = 3, base_delay: float = 2.0,
                    logger=None):
    """Decorator/wrapper: retry on transient runtime errors."""

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            attempt = 0
            while True:
                try:
                    return f(*args, **kwargs)
                except Exception as exc:  # noqa: BLE001 — filtered below
                    attempt += 1
                    if attempt >= max_attempts or not is_transient(exc):
                        raise
                    delay = base_delay * (2 ** (attempt - 1))
                    if logger is not None:
                        logger.info(
                            "transient failure (attempt %d/%d), retrying in "
                            "%.0fs: %s",
                            attempt,
                            max_attempts,
                            delay,
                            str(exc)[:200],
                        )
                    time.sleep(delay)

        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate
