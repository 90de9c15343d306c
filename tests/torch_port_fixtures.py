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
