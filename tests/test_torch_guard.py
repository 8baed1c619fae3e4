"""The port's ProcessRegistry (tidb_tpu_torch/util/guard.py) under a
garbage collection that runs a dead session's finalizer while the
registry's lock is held by the same thread — as happens when an
allocation inside `register` starts a collection."""

import gc
import threading


class _Session:
    def __init__(self, cid):
        self.conn_id = cid
        self.user = "u"
        self.cycle = self            # collected only by the cycle collector


def test_finalizer_under_the_registry_lock_does_not_hang():
    from tidb_tpu_torch.util.guard import ProcessRegistry
    reg = ProcessRegistry()
    was_enabled = gc.isenabled()
    gc.disable()                     # the collection below must be ours
    try:
        live = _Session(1)
        reg.register(live)
        reg.register(_Session(2))    # unreachable at once, in a cycle
        done = threading.Event()

        def collect_under_lock():
            with reg._lock:
                gc.collect()         # runs session 2's finalizer here
            done.set()

        t = threading.Thread(target=collect_under_lock, daemon=True)
        t.start()
        t.join(10)
        hung = not done.is_set()
        if hung:
            reg._lock.release()      # let the stuck finalizer finish
            t.join(10)
        assert not hung, "the finalizer blocked on the registry lock"
    finally:
        if was_enabled:
            gc.enable()
    assert reg.info(2) is None and not reg.kill(2)
    assert [row[0] for row in reg.snapshot()] == [1]
    assert reg.info(1)["session"] is live
