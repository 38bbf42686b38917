"""Unit tests for the datalist batch prefetcher (parallel/prefetch.py)."""

import numpy as np
import pytest

from rpcc.parallel.prefetch import prefetch_loaded_batches


def test_order_batching_and_seeds():
    files = [f"f{i}" for i in range(10)]
    loads = []

    def load(i):
        loads.append(i)
        return np.full((4, 3), i, np.float32)

    batches = list(prefetch_loaded_batches(files, 4, load, seed_base=100))
    assert [len(c) for c, _ in batches] == [4, 4, 2]
    assert [list(s) for _, s in batches] == [
        list(range(100, 104)), list(range(104, 108)), list(range(108, 110))
    ]
    # every batch's clouds line up with its indices
    flat = [c for clouds, _ in batches for c in clouds]
    for i, c in enumerate(flat):
        assert c[0, 0] == i
    assert sorted(loads) == list(range(10))


def test_empty_list():
    assert list(prefetch_loaded_batches([], 4, lambda i: None)) == []


def test_load_error_propagates():
    def load(i):
        if i == 3:
            raise RuntimeError("boom")
        return np.zeros((1, 3), np.float32)

    gen = prefetch_loaded_batches([str(i) for i in range(6)], 2, load)
    with pytest.raises(RuntimeError, match="boom"):
        list(gen)


def test_prefetches_ahead_of_consumer():
    import threading

    started = []
    release = threading.Event()

    def load(i):
        started.append(i)
        return np.zeros((1, 3), np.float32)

    gen = prefetch_loaded_batches([str(i) for i in range(8)], 2, load, depth=2)
    first = next(gen)
    # while the consumer holds batch 0, the reader should have loaded ahead
    import time

    deadline = time.time() + 5.0
    while len(started) < 6 and time.time() < deadline:
        time.sleep(0.01)
    assert len(started) >= 6  # batch 0 + >= 2 batches queued ahead
    release.set()
    rest = list(gen)
    assert len(rest) == 3


def test_abandoned_generator_retires_reader():
    """Closing the generator early (consumer exception / break) must unblock
    and retire the reader thread instead of leaving it parked forever on the
    bounded queue with loaded batches pinned."""
    import threading
    import time

    def load(i):
        return np.zeros((1, 3), np.float32)

    gen = prefetch_loaded_batches([str(i) for i in range(64)], 2, load, depth=2)
    next(gen)  # reader is now live and blocking on the full queue
    gen.close()  # GeneratorExit -> finally sets the abandoned event
    deadline = time.time() + 5.0
    while time.time() < deadline:
        readers = [
            t for t in threading.enumerate() if t.name == "datalist-prefetch"
        ]
        if not any(t.is_alive() for t in readers):
            return
        time.sleep(0.05)
    raise AssertionError("prefetch reader thread still alive after close()")
