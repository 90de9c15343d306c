"""The kernel build cache of the PyTorch port (``kernels/build.py``).

A library is named by a hash of everything it is built from, so that a
changed source, header or flag never loads a stale library; and every file
a kernel is built from is packaged. Nothing here runs ``nvcc``.
"""

import ast
import fnmatch
import glob
import os

import pytest

from ray_shuffling_data_loader_tpu_torch.kernels import build

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, text):
    path.write_text(text)
    return str(path)


def test_library_name_follows_an_included_header(tmp_path):
    header = tmp_path / "prims.cuh"
    _write(header, "#pragma once\nconstexpr int kTile = 64;\n")
    source = _write(tmp_path / "kernel.cu",
                    '#include <stdint.h>\n#include "prims.cuh"\n'
                    "int f() { return kTile; }\n")
    before = build.library_path("rsdl_test", source)
    assert build.library_path("rsdl_test", source) == before
    _write(header, "#pragma once\nconstexpr int kTile = 128;\n")
    after = build.library_path("rsdl_test", source)
    assert after != before
    assert after.startswith(build.BUILD_DIR)


def test_library_name_follows_a_header_of_a_header(tmp_path):
    inner = tmp_path / "inner.cuh"
    _write(inner, "constexpr int kStages = 2;\n")
    _write(tmp_path / "outer.cuh", '#pragma once\n#include "inner.cuh"\n')
    source = _write(tmp_path / "kernel.cu", '#include "outer.cuh"\n')
    before = build.library_path("rsdl_test", source)
    _write(inner, "constexpr int kStages = 3;\n")
    assert build.library_path("rsdl_test", source) != before


def test_library_name_follows_the_source_and_the_flags(tmp_path, monkeypatch):
    source = _write(tmp_path / "kernel.cu", "int f() { return 1; }\n")
    first = build.library_path("rsdl_test", source)
    _write(tmp_path / "kernel.cu", "int f() { return 2; }\n")
    second = build.library_path("rsdl_test", source)
    assert second != first
    monkeypatch.setattr(build, "CUDA_FLAGS", [*build.CUDA_FLAGS, "-lineinfo"])
    assert build.library_path("rsdl_test", source) != second


def test_the_flash_library_hashes_its_hopper_header(tmp_path):
    # A copy of flash_attention.cu beside a copy of the header it includes:
    # changing only the header renames the library.
    kernels = {}
    for name in ("flash_attention.cu", "hopper.cuh"):
        with open(f"{build.KERNEL_DIR}/{name}") as f:
            kernels[name] = _write(tmp_path / name, f.read())
    source = kernels["flash_attention.cu"]
    before = build.library_path("rsdl_torch_flash", source)
    with open(kernels["hopper.cuh"], "a") as f:
        f.write("// changed\n")
    assert build.library_path("rsdl_torch_flash", source) != before


def _setup_keyword(setup_py, name):
    """The ``setup()`` call's ``name`` keyword in ``setup_py``, as ast."""
    with open(setup_py) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "setup"):
            for keyword in node.keywords:
                if keyword.arg == name:
                    return keyword.value
    raise AssertionError(f"setup.py has no setup({name}=...)")


def test_find_packages_takes_the_storage_plane_and_the_pool_worker():
    # An installed port starts its pool's workers as ``python -m
    # <procpool.WORKER_MODULE>`` and reads through ``storage``: both must
    # be in what setup.py's find_packages returns.
    from setuptools import find_packages

    from ray_shuffling_data_loader_tpu_torch import procpool
    call = _setup_keyword(os.path.join(REPO_ROOT, "setup.py"), "packages")
    include = ast.literal_eval(
        next(k.value for k in call.keywords if k.arg == "include"))
    packages = find_packages(where=REPO_ROOT, include=include)
    assert "ray_shuffling_data_loader_tpu_torch.storage" in packages
    worker_package, worker_module = procpool.WORKER_MODULE.rsplit(".", 1)
    assert worker_package in packages
    assert os.path.isfile(os.path.join(
        REPO_ROOT, *worker_package.split("."), worker_module + ".py"))


def _package_data(setup_py):
    """``package_data`` of the ``setup()`` call in ``setup_py``, read with
    ``ast`` (setup.py is not run)."""
    with open(setup_py) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "setup"):
            for keyword in node.keywords:
                if keyword.arg == "package_data":
                    return ast.literal_eval(keyword.value)
    raise AssertionError("setup.py has no setup(package_data=...)")


def test_package_data_ships_every_local_include_of_the_kernels():
    # An installed port builds its kernels from the package's own files:
    # every source and every local header it includes must be packaged.
    globs = _package_data(os.path.join(REPO_ROOT, "setup.py"))[
        "ray_shuffling_data_loader_tpu_torch.kernels"]
    sources = sorted(glob.glob(os.path.join(build.KERNEL_DIR, "*.cu")))
    assert len(sources) == 2
    shipped = set()
    for source in sources:
        for path in build.local_sources(source):
            rel = os.path.relpath(path, build.KERNEL_DIR)
            assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
            shipped.add(rel)
    assert "hopper.cuh" in shipped


def test_a_missing_local_header_raises(tmp_path):
    source = _write(tmp_path / "kernel.cu", '#include "absent.cuh"\n')
    with pytest.raises(FileNotFoundError, match="absent.cuh"):
        build.library_path("rsdl_test", source)
