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
                    logger=None, agree=None):
    """Decorator/wrapper: retry on transient runtime errors.

    ``agree`` (several ranks of one process group, e.g.
    ``parallel.multihost.failure_vote``): called on every rank after
    every attempt with its exception (or None); it returns "done" when no
    rank failed, "retry" when the ranks may retry together, and "raise"
    otherwise (a rank whose own attempt succeeded then raises a
    ``RuntimeError`` naming the peers' failure)."""

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            attempt = 0
            while True:
                attempt += 1
                try:
                    out, exc = f(*args, **kwargs), None
                except Exception as err:  # noqa: BLE001 — filtered below
                    out, exc = None, err
                if agree is None:
                    verdict = ("done" if exc is None else
                               "retry" if is_transient(exc) else "raise")
                else:
                    verdict = agree(exc)
                if verdict == "done":
                    return out
                if verdict == "raise" or attempt >= max_attempts:
                    if exc is None:
                        raise RuntimeError(
                            "a peer rank's attempt failed: not retried")
                    raise exc
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
