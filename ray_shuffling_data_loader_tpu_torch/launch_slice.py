"""One-command launcher of a world of ``train_shuffle`` processes, one per
host (counterpart of the JAX package's ``examples/launch_slice.py``).

SSH mode: the hosts exist and share the repository's path (or ``--repo``)::

    RSDL_HOSTS="10.0.0.2:18515,10.0.0.3:18515" \\
    python -m ray_shuffling_data_loader_tpu_torch.launch_slice \\
        --ssh user@host-0,user@host-1 --out ./slice_stats \\
        -- --num-rows 2000000 --num-files 16 --num-epochs 4 \\
           --batch-size 131072

Local mode: every "host" a process on this machine::

    RSDL_HOSTS="127.0.0.1:18515,127.0.0.1:18516" \\
    python -m ray_shuffling_data_loader_tpu_torch.launch_slice --local \\
        --out /tmp/slice_stats -- --cpu --tiny-model --num-rows 4000 \\
        --num-files 2 --num-epochs 2 --batch-size 500

Everything after ``--`` goes to ``train_shuffle`` as it is;
``--distributed`` and ``--stats-dir`` are added. ``RSDL_HOSTS`` (the
shuffle endpoints, one per host, in rank order) defines the world. Host
``i`` gets ``RSDL_HOSTS``, ``MASTER_ADDR`` (host 0's address),
``MASTER_PORT`` (``--coordinator-port``), ``WORLD_SIZE``, ``RANK=i`` and
``LOCAL_RANK=0``. The launcher polls every host, stops the others when
one fails, and returns the first non-zero exit code; then, in SSH mode, it
gathers each host's ``host_{i}_epochs.csv`` into ``--out/host_{i}/`` with
``scp``. A host's CSV from an earlier run is removed before it starts.
Exit code 2: ``RSDL_HOSTS`` missing, ``--ssh`` targets that do not match
it, or ``--local`` with ``--ssh``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import threading
import time

TRAIN_MODULE = "ray_shuffling_data_loader_tpu_torch.train_shuffle"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ssh", type=str, default=None,
                   help="comma-separated SSH targets, one per RSDL_HOSTS "
                        "entry, in the same order")
    p.add_argument("--local", action="store_true",
                   help="run every host as a local process (no SSH)")
    p.add_argument("--repo", type=str, default=None,
                   help="the repository's path on the remote hosts "
                        "(default: this one's)")
    p.add_argument("--out", type=str, default="./slice_stats",
                   help="local directory for the hosts' stats CSVs")
    p.add_argument("--coordinator-port", type=int, default=8476,
                   help="MASTER_PORT: the process group's rendezvous port "
                        "on host 0")
    p.add_argument("--remote-stats-dir", type=str,
                   default="/tmp/rsdl_slice_stats",
                   help="where each remote host writes its CSV")
    p.add_argument("--python", type=str, default="python3",
                   help="Python interpreter on the hosts")
    if argv is None:
        argv = sys.argv[1:]
    train_args: list = []
    if "--" in argv:
        split = argv.index("--")
        argv, train_args = argv[:split], argv[split + 1:]
    args = p.parse_args(argv)
    args.train_args = train_args
    return args


def _stream(proc: subprocess.Popen, tag: str) -> None:
    for line in proc.stdout:
        sys.stdout.write(f"[{tag}] {line}")
        sys.stdout.flush()


def _wait_all(procs) -> int:
    """Poll every host (an early failure strands the others in their
    collectives, so waiting in order could hang); stop the rest once one
    fails. Returns the first non-zero exit code, else 0."""
    rc = 0
    running = dict(enumerate(procs))
    while running:
        for i in list(running):
            proc, thread = running[i]
            if proc.poll() is None:
                continue
            del running[i]
            thread.join(timeout=10)
            if proc.returncode != 0:
                print(f"[launcher] host {i} exited rc={proc.returncode}",
                      file=sys.stderr)
                rc = rc or proc.returncode
        if rc and running:
            for i, (proc, _) in running.items():
                print(f"[launcher] stopping host {i} (peer failed)",
                      file=sys.stderr)
                proc.kill()
        if running:
            time.sleep(0.2)
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    hosts_env = os.environ.get("RSDL_HOSTS")
    if not hosts_env:
        print("RSDL_HOSTS is required: comma-separated host:port shuffle "
              "endpoints, one per host, in rank order", file=sys.stderr)
        return 2
    endpoints = [h.strip() for h in hosts_env.split(",") if h.strip()]
    world = len(endpoints)
    if args.local and args.ssh:
        print("--local and --ssh are mutually exclusive", file=sys.stderr)
        return 2
    ssh_targets = None
    if not args.local:
        if not args.ssh:
            print("need --ssh targets (or --local)", file=sys.stderr)
            return 2
        ssh_targets = [t.strip() for t in args.ssh.split(",") if t.strip()]
        if len(ssh_targets) != world:
            print(f"--ssh lists {len(ssh_targets)} targets but RSDL_HOSTS "
                  f"has {world} endpoints", file=sys.stderr)
            return 2

    repo_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    remote_repo = args.repo or repo_dir
    master_addr = endpoints[0].rsplit(":", 1)[0]
    # The hosts run in the repository: resolve --out against the
    # launcher's working directory first.
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)

    procs = []
    # The launcher starts the hosts it was given, one process each: its
    # host list is the world by definition.
    # rsdl-lint: disable=fixed-world-assumption
    for i in range(world):
        stats_dir = (os.path.join(args.out, f"host_{i}") if args.local
                     else args.remote_stats_dir)
        stale = os.path.join(stats_dir, f"host_{i}_epochs.csv")
        env_pairs = {
            "RSDL_HOSTS": hosts_env,
            "MASTER_ADDR": master_addr,
            "MASTER_PORT": str(args.coordinator_port),
            "WORLD_SIZE": str(world),
            "RANK": str(i),
            "LOCAL_RANK": "0",
        }
        train_cmd = [args.python, "-m", TRAIN_MODULE, "--distributed",
                     "--stats-dir", stats_dir, *args.train_args]
        if args.local:
            if os.path.exists(stale):
                os.remove(stale)
            env = dict(os.environ, **env_pairs,
                       PYTHONPATH=repo_dir + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            env.setdefault("PYTHONUNBUFFERED", "1")
            # The hosts share this machine's cores (as torchrun does for
            # several processes per node).
            env.setdefault("OMP_NUM_THREADS",
                           # rsdl-lint: disable=fixed-world-assumption
                           str(max(1, (os.cpu_count() or 1) // world)))
            proc = subprocess.Popen(
                [sys.executable] + train_cmd[1:], cwd=repo_dir, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        else:
            exports = " ".join(f"{k}={shlex.quote(v)}"
                               for k, v in env_pairs.items())
            remote = (f"cd {shlex.quote(remote_repo)} && "
                      f"rm -f {shlex.quote(stale)} && {exports} "
                      + " ".join(shlex.quote(c) for c in train_cmd))
            # -tt: killing the local ssh client hangs up the remote
            # session, so stopping a host stops its trainer; stdin from
            # /dev/null keeps the pty off the launcher's own terminal.
            proc = subprocess.Popen(
                ["ssh", "-tt", "-o", "BatchMode=yes", ssh_targets[i],
                 remote],
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        thread = threading.Thread(target=_stream, args=(proc, f"host {i}"),
                                  daemon=True, name=f"rsdl-slice-stream-{i}")
        thread.start()
        procs.append((proc, thread))

    rc = _wait_all(procs)
    if rc:
        return rc
    if not args.local:
        for i, target in enumerate(ssh_targets):
            dest = os.path.join(args.out, f"host_{i}")
            os.makedirs(dest, exist_ok=True)
            # Only this run's file of this rank.
            gather = subprocess.run(
                ["scp", "-o", "BatchMode=yes",
                 f"{target}:{args.remote_stats_dir}/host_{i}_epochs.csv",
                 dest],
                capture_output=True, text=True)
            if gather.returncode != 0:
                print(f"[launcher] gather from host {i} failed: "
                      f"{gather.stderr.strip()}", file=sys.stderr)
                rc = rc or gather.returncode
    print(f"[launcher] done; stats under {args.out}/host_*/")
    return rc


if __name__ == "__main__":
    sys.exit(main())
