"""Picklable tasks for the process-pool tests: the pool's workers
unpickle them by importing this module, which loads neither torch nor
JAX (the workers must stay without both)."""

import os
import sys
import time


def worker_report(hold_s: float = 0.0, env_name: str = ""):
    """What a worker has loaded: its pid and parent's, whether torch or
    JAX is in its modules, the GPUs it may see and ``env_name``'s value
    (after holding ``hold_s``)."""
    time.sleep(hold_s)
    return {"pid": os.getpid(), "ppid": os.getppid(),
            "torch": "torch" in sys.modules, "jax": "jax" in sys.modules,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "env": os.environ.get(env_name) if env_name else None}


def die(code: int):
    """End the worker that runs it."""
    os._exit(code)
