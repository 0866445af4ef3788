"""Building the kernels (repro_torch/kernels/nvcc.py) from several threads:
the transports' worker threads may launch a kernel for the first time
together, so ``launcher`` builds and loads each library once, under a
lock, while the other callers wait. nvcc and the library are stubbed: the
test exercises the lock path on the CPU."""
import threading
import time

import pytest

from repro_torch.kernels import nvcc


class _Lib:
    def __init__(self, path):
        self.path = path
        self.fake_launch = object.__new__(_Entry)


class _Entry:
    pass


@pytest.mark.parametrize("n_threads", [2, 8])
def test_launcher_builds_once_from_many_threads(monkeypatch, tmp_path, n_threads):
    src = tmp_path / "fake.cu"
    src.write_text("// stub")
    builds, loads = [], []

    def slow_build(sources):
        builds.append(list(sources))
        time.sleep(0.05)  # every other thread arrives while this one builds
        return {s.stem: 0.0 for s in sources}

    def load(path):
        loads.append(path)
        return _Lib(path)

    monkeypatch.setattr(nvcc, "build_all", slow_build)
    monkeypatch.setattr(nvcc.ctypes, "CDLL", load)
    monkeypatch.setattr(nvcc, "_FUNCS", {})
    got = [None] * n_threads
    start = threading.Barrier(n_threads)

    def call(k):
        start.wait()
        got[k] = nvcc.launcher(src, [nvcc.VP, nvcc.INT])

    threads = [threading.Thread(target=call, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert all(fn is got[0] for fn in got) and got[0] is not None
    assert got[0].argtypes == [nvcc.VP, nvcc.INT]
    # a later call takes the loaded entry without the lock
    assert nvcc.launcher(src, [nvcc.VP]) is got[0] and len(builds) == 1


def test_temporary_build_name_is_per_thread(monkeypatch, tmp_path):
    """Two threads building one source write two temporary files (nvcc is
    stubbed by a command that only creates its output)."""
    src = tmp_path / "fake.cu"
    src.write_text("// stub")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    outs = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outs.append(out)
            open(out, "w").close()

        def communicate(self):
            time.sleep(0.05)
            return b"", b""

    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc.subprocess, "Popen", Proc)
    start = threading.Barrier(2)

    def build():
        start.wait()
        nvcc.build_all([src])

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 2 and outs[0] != outs[1]
    assert nvcc.lib_path(src).exists()
