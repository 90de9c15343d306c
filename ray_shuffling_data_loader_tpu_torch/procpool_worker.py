"""The process pool's worker template (``procpool.py``)::

    python -m ray_shuffling_data_loader_tpu_torch.procpool_worker FD

``FD`` is the template's end of a socket pair the driver passed on. The
template loads, once, what every worker's first task loads: NumPy,
pyarrow with its Parquet and dataset modules, and pandas (pyarrow's
first array imports it). Then it serves the driver's requests, one at a
time:

- ``("fork", index, sys_path, env)``, followed by the worker's end of a
  new socket pair: fork a worker, which takes ``sys_path`` and ``env``
  (the driver's at the pool's start), loads the port's host modules,
  says ``("ready", import_s)`` and serves tasks through
  :func:`procpool.worker_main`. Replies ``("forked", pid)``.
- ``("status", pid)``: ``("status", alive, exit code)`` of a worker
  (its exit code once it has ended and been reaped here, else None).
- ``("signal", pid, sig)``: signal a worker that has not ended. Only
  here is that safe: a worker's pid names no other process until this
  process reaps it, and it reaps only while serving a request.
- ``None``, or the end of the connection: exit.

A worker is a fork of this process, never of the driver: it shares no
CUDA state, imports no torch, and does not run the driver's
``__main__``. This module, and what it imports, loads no torch.
"""

import os
import signal
import sys
import timeit
import warnings
from multiprocessing import reduction
from multiprocessing.connection import Connection


def _warm() -> float:
    """Load the modules every worker's first task loads; their seconds."""
    start = timeit.default_timer()
    import pyarrow as pa
    import pyarrow.dataset  # noqa: F401  (pq.read_table's first call)
    import pyarrow.parquet  # noqa: F401
    pa.array([0])  # imports pandas, where installed
    return timeit.default_timer() - start


def _serve_worker(fd: int, index: int, sys_path, env) -> None:
    """A forked worker's life: never returns."""
    code = 0
    try:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = sys_path
        conn = Connection(fd)
        start = timeit.default_timer()
        from ray_shuffling_data_loader_tpu_torch import procpool
        procpool.load_worker_modules()
        conn.send(("ready", timeit.default_timer() - start))
        procpool.worker_main(conn, index)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 0
    except BaseException:  # noqa: BLE001 - the driver sees the death
        import traceback
        traceback.print_exc()
        code = 1
    finally:
        for stream in (sys.stdout, sys.stderr):
            try:
                stream.flush()
            except (OSError, ValueError):
                pass
        os._exit(code)


def main(argv) -> None:
    conn = Connection(int(argv[0]))
    conn.send(("ready", _warm()))
    live = set()
    statuses = {}

    def reap() -> None:
        # ChildProcessError: no children left.
        try:
            while True:
                pid, status = os.waitpid(-1, os.WNOHANG)
                if pid == 0:
                    return
                live.discard(pid)
                statuses[pid] = os.waitstatus_to_exitcode(status)
        except ChildProcessError:
            return

    # A service loop: it ends with the connection.
    # rsdl-lint: disable=unbounded-retry
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        reap()
        if msg is None:
            break
        if msg[0] == "status":
            conn.send(("status", msg[1] in live, statuses.get(msg[1])))
            continue
        if msg[0] == "signal":
            if msg[1] in live:
                os.kill(msg[1], msg[2])
            conn.send(("signaled", msg[1] in live))
            continue
        _, index, sys_path, env = msg
        fd = reduction.recv_handle(conn)
        # NumPy's BLAS pool threads are the only other threads here, and
        # OpenBLAS stops and restarts them around a fork itself.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            pid = os.fork()
        if pid == 0:
            conn.close()
            _serve_worker(fd, index, sys_path, env)
        os.close(fd)
        live.add(pid)
        statuses.pop(pid, None)  # a reused pid's earlier worker
        conn.send(("forked", pid))


if __name__ == "__main__":
    main(sys.argv[1:])
