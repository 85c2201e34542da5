"""File-bus work queue (parallel/taskbus.py): claim exclusivity,
coordinator work-stealing, worker serve loop, polish handler parity."""

import threading

import numpy as np

from flye_jax.parallel.taskbus import TaskBus


def _double(payload):
    return {"y": payload["x"] * 2}


def test_coordinator_self_processes(tmp_path):
    """collect() with no workers claims and runs every task itself."""
    bus = TaskBus(str(tmp_path), 0)
    bus.register("dbl", _double)
    for i in range(5):
        bus.submit("dbl", f"t{i}", {"x": np.full(3, i)})
    res = bus.collect("dbl", [f"t{i}" for i in range(5)])
    for i in range(5):
        np.testing.assert_array_equal(res[f"t{i}"]["y"], np.full(3, 2 * i))


def test_worker_serves_until_done(tmp_path):
    coord = TaskBus(str(tmp_path), 0)
    coord.register("dbl", _double)
    worker = TaskBus(str(tmp_path), 1)
    worker.register("dbl", _double)
    t = threading.Thread(target=worker.serve, kwargs={"poll_s": 0.01})
    t.start()
    try:
        for i in range(8):
            coord.submit("dbl", f"t{i}", {"x": np.full(2, i)})
        res = coord.collect("dbl", [f"t{i}" for i in range(8)])
        assert len(res) == 8
        for i in range(8):
            np.testing.assert_array_equal(res[f"t{i}"]["y"],
                                          np.full(2, 2 * i))
    finally:
        coord.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()


def test_claim_is_exclusive(tmp_path):
    b0 = TaskBus(str(tmp_path), 0)
    b1 = TaskBus(str(tmp_path), 1)
    b0.submit("s", "only", {"x": np.zeros(1)})
    task = b0._pending("s")[0]
    c0 = b0._try_claim(task)
    c1 = b1._try_claim(task)
    assert (c0 is None) != (c1 is None)  # exactly one winner


def test_polish_task_handler_matches_direct(tmp_path):
    """The bus polish handler reproduces polish_bubbles on the same
    packed chunk (native CPU path both ways)."""
    from flye_jax.ops.polish import polish_bubbles
    from flye_jax.polishing.polisher import _polish_task

    rng = np.random.default_rng(11)
    B, C, Cb, R, S = 6, 20, 28, 5, 40
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        p = rng.integers(0, C, 2)
        cand[i, p] = (cand[i, p] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))

    direct = polish_bubbles(cand, clen, branches, blen, bmask, subs,
                            max_iters=16)
    out = _polish_task(dict(cand=cand, clen=clen, branches=branches,
                            blen=blen, bmask=bmask.astype(np.uint8),
                            subs=subs, max_iters=np.int32(16)),
                       prefer_native=True)
    np.testing.assert_array_equal(np.asarray(direct[0]), out["cand"])
    np.testing.assert_array_equal(np.asarray(direct[1]), out["clen"])
