"""The wrappers' launch counters, kept right across threads.

Every change to a counter (``<wrapper>.launches``, ``.tc_launches``,
``.gemv_launches``) goes through :func:`add` under one lock. A thread
that captures a CUDA graph (:func:`others_during`) learns what the other
threads added meanwhile, so that its capture's delta holds its own
launches only: in a fleet a new engine captures its graphs while another
engine serves."""

import contextlib
import threading

_lock = threading.Lock()
# capturing thread -> {(wrapper, counter): n} the other threads added
_others = {}


def add(changes):
    """Add ``n`` to ``wrapper.<counter>`` for each ``(wrapper, counter,
    n)``, noting it for every other thread inside :func:`others_during`."""
    me = threading.get_ident()
    with _lock:
        for w, attr, n in changes:
            setattr(w, attr, getattr(w, attr) + n)
            for t, seen in _others.items():
                if t != me:
                    seen[(w, attr)] = seen.get((w, attr), 0) + n


def launched(wrapper, *counters):
    """One launch of ``wrapper``'s kernel: one more on ``launches`` and on
    each route counter in ``counters``."""
    add([(wrapper, c, 1) for c in ("launches",) + counters])


@contextlib.contextmanager
def others_during(read):
    """Run the block with this thread registered as capturing. Yields
    ``(before, result)``: ``before`` is ``read()`` taken as the block
    starts; on exit ``result`` holds ``"after"``, ``read()`` as it ends,
    and ``"others"``, ``{(wrapper, counter): n}`` that the other threads
    added in between, both taken under the lock."""
    me = threading.get_ident()
    with _lock:
        _others[me] = {}
        before = read()
    result = {}
    try:
        yield before, result
    finally:
        with _lock:
            result["after"] = read()
            result["others"] = _others.pop(me)
