"""Process supervision: restart a dead queue-server process (own copy of
the JAX package's ``runtime/supervisor.py``).

A :class:`ProcessSupervisor` watches a child process and, when it dies
(``kill -9``, OOM, an injected ``queue_server_crash``), starts it again
after a bounded, jittered backoff. The restarted server
(``multiqueue_service.serve_pipeline``) reloads its watermark journal,
asks ``plan.ir.resume_from_watermarks`` where to resume and re-runs the
deterministic shuffle lineage from there, queueing only the undelivered
remainder; consumers redial through their retry policy and resume where
their acks left off.

:func:`launch_supervised_queue_server` runs ``python -m
ray_shuffling_data_loader_tpu_torch.multiqueue_service config.json`` with
``CUDA_VISIBLE_DEVICES=""`` in its environment: the server shuffles on
the host and can never open a context on the trainer's card.
:func:`launch_supervised_queue_shards` starts one such child per serving
shard, each with its own journal, handle directory and restart budget.

Stdlib only: this module never imports the service itself.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

from ray_shuffling_data_loader_tpu_torch.runtime import metrics as rt_metrics
from ray_shuffling_data_loader_tpu_torch.runtime import policy as rt_policy
from ray_shuffling_data_loader_tpu_torch.runtime import retry as rt_retry
from ray_shuffling_data_loader_tpu_torch.runtime import (
    telemetry as rt_telemetry)
from ray_shuffling_data_loader_tpu_torch.utils.logger import (
    setup_custom_logger)

logger = setup_custom_logger(__name__)

# The restart budget (RSDL_SUPERVISOR_RETRY_*): deeper than a call's
# retries, since a preempted host may kill the server several times in
# one run, and with a wider backoff cap so a crash loop does not spin.
rt_policy.register_defaults("supervisor", retry_max_attempts=6,
                            retry_initial_backoff_s=0.25,
                            retry_max_backoff_s=5.0)


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port free now. A supervised server must come back on the
    same address (its consumers redial it), so the port is chosen once
    here instead of by the child binding port 0."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind((host, 0))
        return probe.getsockname()[1]
    finally:
        probe.close()


class ProcessSupervisor:
    """Keep one child process alive across crashes.

    ``spawn(restart_index)`` starts a fresh ``subprocess.Popen``. A
    monitor thread waits on the child and, unless :meth:`stop` was
    called, counts the death (``rsdl_queue_server_restarts_total`` and a
    ``queue_server_crash`` event, the plain twin of the fault site),
    sleeps a decorrelated-jitter backoff and spawns again. The budget and
    the backoff are the ``supervisor`` component's retry keys; a spent
    budget marks the supervisor ``failed`` and stops: a permanent failure
    shows, it does not flap forever.
    """

    def __init__(self, spawn: Callable[[int], subprocess.Popen],
                 name: str = "queue-server",
                 on_restart: Optional[Callable[[int], None]] = None):
        self._spawn = spawn
        self._name = name
        self._on_restart = on_restart
        policy = rt_retry.RetryPolicy.for_component("supervisor")
        self._max_restarts = policy.max_attempts
        self._backoffs = policy.backoffs()
        self._restarts_counter = rt_metrics.counter(
            "rsdl_queue_server_restarts_total",
            "supervised queue-server processes restarted after death")
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._stopping = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.restarts = 0
        self.failed = False
        #: A directory of the child's own (its config), removed by stop().
        self.cleanup_dir: Optional[str] = None

    @property
    def proc(self) -> Optional[subprocess.Popen]:
        with self._lock:
            return self._proc

    @property
    def pid(self) -> Optional[int]:
        proc = self.proc
        return proc.pid if proc is not None else None

    def start(self) -> "ProcessSupervisor":
        with self._lock:
            self._proc = self._spawn(0)
        logger.info("%s: supervised child started (pid %d)", self._name,
                    self._proc.pid)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name=f"rsdl-supervisor-{self._name}")
        self._monitor.start()
        return self

    def _monitor_loop(self) -> None:
        while not self._stopping.is_set():
            proc = self.proc
            if proc is None:
                return
            returncode = proc.wait()
            if self._stopping.is_set():
                return
            self.restarts += 1
            self._restarts_counter.inc()
            rt_telemetry.record("queue_server_crash", rc=returncode,
                                restart=self.restarts)
            if self.restarts >= self._max_restarts:
                self.failed = True
                logger.error(
                    "%s: child died (rc=%s) and the restart budget (%d) "
                    "is exhausted; giving up", self._name, returncode,
                    self._max_restarts)
                return
            pause = next(self._backoffs)
            logger.error("%s: child died (rc=%s); restart %d/%d in %.2fs",
                         self._name, returncode, self.restarts,
                         self._max_restarts - 1, pause)
            if self._stopping.wait(pause):
                return
            with self._lock:
                if self._stopping.is_set():
                    return
                self._proc = self._spawn(self.restarts)
            logger.info("%s: supervised child restarted (pid %d)",
                        self._name, self._proc.pid)
            if self._on_restart is not None:
                try:
                    self._on_restart(self.restarts)
                except Exception:  # noqa: BLE001 - supervision goes on
                    logger.exception("%s: on_restart hook failed",
                                     self._name)

    def stop(self, kill_timeout_s: float = 5.0) -> None:
        """Stop supervising and end the child (SIGTERM, then SIGKILL).
        Idempotent."""
        self._stopping.set()
        proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=kill_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=kill_timeout_s)
        if self._monitor is not None:
            self._monitor.join(timeout=kill_timeout_s)
        if self.cleanup_dir is not None:
            shutil.rmtree(self.cleanup_dir, ignore_errors=True)

    def __enter__(self) -> "ProcessSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def launch_supervised_queue_server(config: dict,
                                   name: str = "queue-server"
                                   ) -> "tuple[ProcessSupervisor, tuple]":
    """Start a supervised queue-server process serving the pipeline
    ``config`` describes (``multiqueue_service.serve_pipeline``'s keys;
    ``port`` defaults to a free one; ``child_env`` adds to the child's
    environment and is not passed on).

    Returns ``(supervisor, (host, port))``: consumers dial the address
    with their connect retry, and it stays valid across restarts.
    """
    config = dict(config)
    host = config.setdefault("host", "127.0.0.1")
    if not config.get("port"):
        config["port"] = free_port(host)
    child_env = config.pop("child_env", None) or {}
    config_dir = tempfile.mkdtemp(prefix="rsdl-qserver-")
    config_path = os.path.join(config_dir, "server.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    env = dict(os.environ)
    # The child imports this package from where the caller did, whatever
    # its working directory.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # The server shuffles on the host: it must never open (or wait on) a
    # context on the card the trainer owns.
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.update(child_env)

    def spawn(restart_index: int) -> subprocess.Popen:
        # stdout would carry the READY line; stderr (the server's logs)
        # stays the driver's.
        return subprocess.Popen(
            [sys.executable, "-m",
             "ray_shuffling_data_loader_tpu_torch.multiqueue_service",
             config_path],
            stdout=subprocess.DEVNULL, env=env)

    supervisor = ProcessSupervisor(spawn, name=name)
    supervisor.cleanup_dir = config_dir
    return supervisor.start(), (host, config["port"])


def launch_supervised_queue_shards(config: dict, num_shards: int,
                                   name: str = "queue-shard"):
    """The sharded serving plane as supervised processes: one
    :func:`launch_supervised_queue_server` child per shard, serving the
    ranks ``plan.ir.shard_ranks`` gives it, with its own watermark
    journal (``checkpoint.shard_journal_path``), its own handle
    directory (``handle_dir``/``s<shard>`` where the config names a
    root) and its own restart budget: a SIGKILLed shard recovers as one
    server does while its siblings serve on.

    Returns ``(supervisors, shard_map)``: consumers give the
    :class:`plan.ir.ShardMap` to ``dataset.connect_remote_queue``.
    """
    # plan.ir and checkpoint load no torch; imported here so that this
    # module stays stdlib-only at import.
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    from ray_shuffling_data_loader_tpu_torch.plan import ir as plan_ir

    num_shards = max(1, int(num_shards))
    config = dict(config)
    host = config.setdefault("host", "127.0.0.1")
    journal_path = config["journal_path"]
    handle_root = config.pop("handle_dir", None)
    ports = [free_port(host) for _ in range(num_shards)]
    supervisors = []
    try:
        for shard in range(num_shards):
            shard_config = dict(
                config, port=ports[shard], shard_index=shard,
                num_shards=num_shards,
                journal_path=ckpt.shard_journal_path(journal_path, shard,
                                                     num_shards))
            if handle_root:
                shard_config["handle_dir"] = os.path.join(handle_root,
                                                          f"s{shard}")
            supervisor, _ = launch_supervised_queue_server(
                shard_config, name=f"{name}-{shard}")
            supervisors.append(supervisor)
    except BaseException:
        for supervisor in supervisors:
            supervisor.stop()
        raise
    shard_map = plan_ir.ShardMap(
        num_trainers=max(1, int(config["num_trainers"])),
        addresses=[(host, port) for port in ports])
    return supervisors, shard_map


def wait_for_server(address: "tuple[str, int]",
                    timeout_s: float = 30.0) -> bool:
    """Poll until something accepts on ``address`` (or time out)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.settimeout(1.0)
        try:
            probe.connect(tuple(address))
            return True
        except OSError:
            # A deadline-bounded probe of a local listener:
            # rsdl-lint: disable=unbounded-retry
            time.sleep(0.1)
        finally:
            probe.close()
    return False
