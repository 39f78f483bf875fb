"""CUDA graph capture beside other threads and the cycle collector
(framework/cuda_graph.py, "Threads"), on the card.  Every test needs the
card and skips without one; run on the card with

    python -m pytest --noconftest tests/test_torch_cuda_capture.py -m cuda
"""

import threading
import time

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def test_a_capture_survives_the_collector_and_another_threads_sync(card):
    """Two events invalidate a capture in progress even in the
    thread-local mode: Python's cycle collector destroying another CUDA
    graph in the capturing thread, and a device-wide synchronisation from
    another thread.  The collector is off during a capture, and
    cuda_graph.synchronize waits for the capture to end: a segment whose
    capture allocates enough to trigger the collector over a dead graph,
    while another thread synchronises, captures and replays the eager
    product."""
    import gc

    from paddle_tpu_torch.framework import cuda_graph
    from paddle_tpu_torch.framework.cuda_graph import CapturedSegment

    x = torch.randn(64, 96, device=card)
    w = torch.randn(96, 32, device=card)
    want = torch.relu(x @ w)
    dead = CapturedSegment(lambda rng, a: (a * 2.0,), ["x"], ["y"], card,
                           label="dead")
    for _ in range(3):                # warm-up, capture, replay
        dead(None, x)
    cycle = {"segment": dead}
    cycle["self"] = cycle
    del dead, cycle
    started, order = threading.Event(), []

    def body(rng, a, b):
        started.set()
        junk = [[] for _ in range(20000)]   # past every collector threshold
        time.sleep(0.2)                     # the other thread syncs now
        order.append("body")
        return (torch.relu(a @ b) + 0 * len(junk),)

    def other():
        started.wait(10)
        cuda_graph.synchronize(card)
        order.append("sync")

    seg = CapturedSegment(body, ["x", "w"], ["y"], card, label="collector")
    got = [seg(None, x, w)[0]]        # warm-up
    order.clear()
    started.clear()
    thresholds = gc.get_threshold()
    gc.set_threshold(100, 1, 1)
    t = threading.Thread(target=other)
    t.start()
    try:
        got.append(seg(None, x, w)[0])    # capture
    finally:
        gc.set_threshold(*thresholds)
        t.join(timeout=30)
    assert order == ["body", "sync"], order
    got += [seg(None, x, w)[0] for _ in range(2)]
    for y in got:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
