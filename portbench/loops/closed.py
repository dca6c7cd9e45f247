"""One client in a closed loop: it sends the next query of its stream as
soon as the last one's result is on the host, until ``seconds`` have
passed.  The window closes when the query running at ``seconds`` ends.

``drive`` returns what every reader of the window needs: the queries
attempted, the completed ones with their results, each query's latency
in ms (``None`` for one that failed), the seconds at which each ended,
the failures, and the window's length.
"""
from __future__ import annotations

import contextlib
import time


def drive(execute, stream, seconds: float, span=None) -> dict:
    """``execute(name, params)`` runs one query to its result on the host;
    ``stream`` yields (name, params); ``span(name)``, where given, is a
    context manager that marks each query in a trace."""
    span = span or (lambda name: contextlib.nullcontext())
    done, latencies_ms, ends, failures = [], [], [], []
    attempted = 0
    w0 = time.perf_counter()
    w_end, last = w0 + seconds, w0
    while time.perf_counter() < w_end:
        name, params = next(stream)
        attempted += 1
        with span(f"portbench.{name}"):
            ts = time.perf_counter()
            try:
                result = execute(name, params)
            except Exception as exc:  # a failed query counts as missing; the run goes on
                failures.append(f"{name} {params}: {type(exc).__name__}: {exc}")
                result = None
            last = time.perf_counter()
        ends.append(last - w0)
        if result is None:
            latencies_ms.append(None)
        else:
            latencies_ms.append((last - ts) * 1e3)
            done.append((name, params, result))
    return {"attempted": attempted, "done": done, "latencies_ms": latencies_ms,
            "ends": ends, "failures": failures, "window_s": last - w0}
