"""Framework logger: loud, rate-limited cap/truncation warnings.

The reference has no bounded shapes, so nothing can silently truncate
(Velvet/KMC grow with their input, assemble_gaps.py:96-118). The device
design pads to static shapes instead — every static bound that can
drop data MUST either auto-grow or warn through here, never silently
truncate (VERDICT r1 "missing" #5).
"""

from __future__ import annotations

import logging

logger = logging.getLogger("gappadder")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[gappadder] %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_seen: dict[str, int] = {}


def warn_cap(key: str, msg: str, *args, every: int = 1) -> None:
    """Loud warning about a capacity bound doing real work.

    ``key`` rate-limits repeats (log 1st occurrence, then every
    ``every``-th). Always counts; counts are queryable in tests via
    ``cap_events``.
    """
    n = _seen.get(key, 0)
    _seen[key] = n + 1
    if n % max(every, 1) == 0:
        logger.warning(msg, *args)


def cap_events(key: str) -> int:
    return _seen.get(key, 0)


def reset_cap_events() -> None:
    _seen.clear()
