"""The port's kernel loader and launch counters under threads (CPU).

A scenario server's dispatcher and a router's replicas launch K1 outside
the main thread, so `kernels.ops` must build and bind a kernel once
whatever thread first needs it, stage concurrent builds in files of their
own, and count launches without losing an increment.  The build and the
binder are replaced by counting fakes here (there is no nvcc on the CPU);
tests/test_torch_cuda.py has the same first use on the card.
"""
import fcntl
import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_THREADS = 8


def _together(fn, n=N_THREADS):
    """Run ``fn(i)`` in ``n`` threads released at once; re-raise the first
    error any of them met."""
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait(30)
            fn(i)
        except BaseException as e:      # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    if errors:
        raise errors[0]


def test_load_library_builds_and_binds_once_from_many_threads(monkeypatch):
    builds, binds = [], []
    lib = object()

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.05)                 # widen the check-then-build race
        return {}

    monkeypatch.setattr(ops, "build_all", slow_build)
    monkeypatch.setattr(ops.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(ops, "_BINDERS", {"ra_aggregate": lambda cdll: (
        binds.append(cdll) or lib)})
    monkeypatch.setattr(ops, "_LIBS", {})
    got = []
    _together(lambda i: got.append(ops.load_library("ra_aggregate")))
    assert builds == [["ra_aggregate"]]
    assert len(binds) == 1
    assert got == [lib] * N_THREADS


def test_concurrent_builds_stage_in_files_of_their_own(monkeypatch, tmp_path):
    """Two threads building the same kernel at once: the kernel's file lock
    lets one nvcc run, into a temporary file of its own process and
    thread; the other thread waits for it and finds the library built."""
    outputs = []

    class FakeNvcc:
        def __init__(self, cmd, **_kw):
            out = cmd[cmd.index("-o") + 1]
            outputs.append(out)
            with open(out, "w") as f:
                f.write("built")
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)             # both builds in flight at once
            return ("", None)

    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ops.subprocess, "Popen", FakeNvcc)
    _together(lambda i: ops.build_all(["ra_aggregate"]), n=2)
    assert len(outputs) == 1
    assert outputs[0].endswith(".tmp") and str(os.getpid()) in outputs[0]
    assert ops.lib_path("ra_aggregate").read_text() == "built"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([
        ops.lib_path("ra_aggregate").name, "ra_aggregate.lock"])


def test_build_waits_for_another_holder_of_the_file_lock(monkeypatch,
                                                         tmp_path):
    """A build holds ``build/<name>.lock`` (an flock, which another process
    holds the same way): while someone else holds it, `build_all` waits;
    when the holder has built the library and lets go, it compiles
    nothing."""
    monkeypatch.setattr(ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ops, "_nvcc", lambda: "nvcc")
    started = []
    monkeypatch.setattr(ops.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    done = threading.Event()
    with open(tmp_path / "ra_aggregate.lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        worker = threading.Thread(
            target=lambda: (ops.build_all(["ra_aggregate"]), done.set()))
        worker.start()
        assert not done.wait(0.3)            # blocked on the lock
        ops.lib_path("ra_aggregate").write_text("built by the holder")
    worker.join(timeout=10)
    assert done.is_set() and started == []


def test_launch_counters_lose_no_increment_under_threads():
    """8 threads x 5000 increments on one counter, with the interpreter
    switching threads as often as it can: the total is exact."""
    counter = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _together(lambda i: [kernels.count_launch(counter, "k")
                             for _ in range(5000)])
    finally:
        sys.setswitchinterval(old)
    assert counter == {"k": N_THREADS * 5000}

