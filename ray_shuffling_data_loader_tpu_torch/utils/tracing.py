"""Stage spans on the PyTorch profiler's timeline (the port of the JAX
package's ``utils/tracing.py``, whose spans are
``jax.profiler.TraceAnnotation``\\ s).

Every hot stage (map, reduce, convert, transfer, train step) is wrapped
in :func:`trace_span`, so a captured trace shows the host pipeline on the
same timeline as the CUDA kernels: whether the device waits on the loader
or the loader on the device. A span is a ``torch.profiler.record_function``
range while a profiler records (one started on this thread, or a
:func:`profile_trace` capture, which records every thread), plus an NVTX
range (``torch.cuda.nvtx.range_push``/``range_pop``) while a CUDA context
exists. Neither is paid where torch is not loaded (the process pool's
workers) or no profiler records and no CUDA context exists.

Capture is explicit (:func:`profile_trace`) or set by the environment
(``RSDL_PROFILE_DIR=/tmp/trace python ...`` with :func:`maybe_profile`):
``torch.profiler.profile`` over the CPU and, where available, CUDA,
exported as Chrome-trace JSON (Perfetto or ``chrome://tracing``).

Only this module of the port's telemetry imports torch, and lazily.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Iterator, Optional

#: Captures of :func:`profile_trace` in progress. Such a capture records
#: every thread, but ``torch.autograd._profiler_enabled()`` is true only
#: on the thread that started it, so the loader's threads read this.
_captures = 0
_captures_lock = threading.Lock()


def _range(name: str) -> contextlib.AbstractContextManager:
    """A profiler range and an NVTX range named ``name``, each only where
    it can be seen; a null context otherwise."""
    torch = sys.modules.get("torch")
    if torch is None:
        return contextlib.nullcontext()
    profiling = _captures > 0 or torch.autograd._profiler_enabled()
    nvtx = torch.cuda.is_initialized()
    if not profiling and not nvtx:
        return contextlib.nullcontext()
    return _torch_range(torch, name, profiling, nvtx)


@contextlib.contextmanager
def _torch_range(torch, name: str, profiling: bool,
                 nvtx: bool) -> Iterator[None]:
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace_span(name: str, kind: Optional[str] = None,
               epoch: Optional[int] = None, task: Optional[int] = None,
               batch: Optional[int] = None) -> Iterator[None]:
    """Named host span, visible in captured profiler traces; cheap when
    none is recording, safe from worker threads. With ``kind`` set, the
    span is also one flight-recorder event (``runtime/telemetry.py``)
    with the given correlation ids: one span, two readers (the profiler
    timeline and the bottleneck attribution)."""
    if kind is None:
        with _range(name):
            yield
        return
    from ray_shuffling_data_loader_tpu_torch.runtime import telemetry
    with telemetry.span(kind, epoch=epoch, task=task, batch=batch):
        with _range(name):
            yield


def step_span(step: int) -> contextlib.AbstractContextManager:
    """Train-step marker: groups a step's kernels on the timeline (the
    JAX package's ``StepTraceAnnotation("train", step_num=step)``)."""
    return _range(f"train#{step}")


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of every thread (host ranges and,
    where CUDA is available, the device timeline) for the duration of the
    block and export it as ``<log_dir>/rsdl-profile-<pid>.json``. Yields
    the profiler, so a caller can read ``key_averages()`` after the
    block."""
    global _captures
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # a torch without the option
        config = None
    with torch.profiler.profile(activities=activities,
                                experimental_config=config) as prof:
        with _captures_lock:
            _captures += 1
        try:
            yield prof
        finally:
            with _captures_lock:
                _captures -= 1
    prof.export_chrome_trace(
        os.path.join(log_dir, f"rsdl-profile-{os.getpid()}.json"))


@contextlib.contextmanager
def maybe_profile(env_var: str = "RSDL_PROFILE_DIR") -> Iterator[None]:
    """Capture a trace iff the environment variable names a directory:
    the zero-code way to profile any run."""
    log_dir: Optional[str] = os.environ.get(env_var)
    if not log_dir:
        yield
        return
    with profile_trace(log_dir):
        yield
