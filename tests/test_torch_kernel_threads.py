"""The port's kernel loader and launch counters under threads (CPU).

A scenario server's dispatcher and a router's replicas launch K1 outside
the main thread, so `kernels.ops` must build and bind a kernel once
whatever thread first needs it, stage concurrent builds in files of their
own, and count launches without losing an increment.  The build and the
binder are replaced by counting fakes here (there is no nvcc on the CPU);
tests/test_torch_cuda.py has the same first use on the card.
"""
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
    """Two threads building the same kernel at once: each nvcc writes its
    own temporary file, so both renames into place succeed."""
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
    assert len(outputs) == 2 and len(set(outputs)) == 2
    assert ops.lib_path("ra_aggregate").read_text() == "built"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ops.lib_path("ra_aggregate").name]


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

