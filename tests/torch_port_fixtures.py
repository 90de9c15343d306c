"""Fixtures shared by the port's test files (import them into a file to
use them there)."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def thread_backend():
    """The importing file's shuffles run on the thread backend, as before
    the process pool (which ``test_torch_port_procpool.py`` holds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RSDL_EXECUTOR_BACKEND", "thread")
        yield


@pytest.fixture
def one_rank_world(tmp_path):
    """A gloo world of this process alone and its ``("data", "model")``
    mesh of (1, 1) on the CPU; the group is destroyed afterwards."""
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
