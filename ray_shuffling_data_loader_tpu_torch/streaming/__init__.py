"""streaming/: continuous ingestion and a windowed shuffle over unbounded
input (own copy of the JAX package's ``streaming/``).

A window is an epoch. Events (arriving files) accumulate into a window
(``window.py``); a sealed window becomes a ``plan.ir.EpochSpec`` with its
provenance in ``window``, so the shuffle driver, the process pool, the
queue service and its exactly-once resume take it as any epoch.

- :mod:`streaming.source`: the :class:`StreamSource` contract, the
  journaled :class:`DirectoryTailSource` and the seeded
  :class:`SyntheticEventSource`.
- :mod:`streaming.window`: the window policies (count, byte and
  stream-time bounds, ``RSDL_STREAM_WINDOW_*``), late events (admit or
  quarantine), the journaled monotone ingest watermark, and sealed
  windows as epoch specs; frozen schedules and their JSON form.
- :mod:`streaming.runner`: :class:`StreamingShuffleRunner`, which shuffles
  window N+1 while window N is served, and ``server_config``, the frozen
  schedule a supervised queue server serves.

Host code: imports no torch.
"""

from ray_shuffling_data_loader_tpu_torch.streaming.source import (  # noqa
    DirectoryTailSource, StreamEvent, StreamSource, SyntheticEventSource)
from ray_shuffling_data_loader_tpu_torch.streaming.window import (  # noqa
    Window, WindowAssembler, WindowPolicy, freeze_schedule,
    specs_from_dicts, specs_to_dicts)
from ray_shuffling_data_loader_tpu_torch.streaming.runner import (  # noqa
    StreamingShuffleRunner)
