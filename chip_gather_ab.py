#!/usr/bin/env python3
"""Time variants of the grouped gather kernel on one NVIDIA GPU.

``python3 chip_gather_ab.py [PARENT.cu]`` builds the package's
``kernels/gather.cu`` and the variants in ``VARIANTS`` (each the package
source with one piece replaced), one ``nvcc`` each, started together.
Every build that compiles is held against ``gather_grouped_reference``,
bit for bit, at the DLRM step's group (the 8 ``mlperf`` tables above 2048
rows, B=2048, E=128, bf16, int32 ids) and at a mixed group (int8/16/32/64
ids, f32 and bf16, E=128 and E=37, into a (B, G, E) tensor). Then each is
timed (device time by CUDA-graph replay, index sets that exceed the L2)
at the DLRM step's group and at its largest table alone with B=131072,
in two turns each, the second in reverse order.
``PARENT.cu`` is an earlier ``gather.cu``, checked and timed as one more
variant; one with the earlier one-table interface
(``rsdl_gather_rows(table, idx, idx_code, out, out_code, batch, vocab,
embed, stream)``) is timed as 8 launches, one per table, unchecked.
Prints the card's name and power limit, then one JSON line per build,
check and timing turn. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
import shutil
import sys
import tempfile

import torch

import chip_smoke as cs

_LOAD_ONCE = '''  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
'''

_POLICY = '''  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
'''

_COPY_ROWS_START = "template <typename OutT>\n__device__ __forceinline__ " \
                   "void copy_rows("

# Each row by one cp.async.bulk copy into shared memory behind a per-warp
# mbarrier (the Pallas kernel's row DMAs), then converted and stored. E <=
# 128 only; a wait that never ends traps instead of hanging the card.
_BULK_COPY_ROWS = r'''template <typename OutT>
__device__ __forceinline__ void copy_rows(const float* const (&src)[kRows],
                                          OutT* dst, int64_t stride,
                                          int rows, int64_t embed, int lane) {
  __shared__ float4 stage[kWarps][kRows][32];
  __shared__ uint64_t bar[kWarps];
  if (embed > 128) __trap();
  const int warp = threadIdx.x >> 5;
  const uint32_t bar_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(&bar[warp]));
  const uint32_t row_bytes = static_cast<uint32_t>(embed * 4);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_addr), "r"(rows * row_bytes) : "memory");
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == r && r < rows) {
      const uint32_t to =
          static_cast<uint32_t>(__cvta_generic_to_shared(&stage[warp][r][0]));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(to), "l"(src[r]), "r"(row_bytes),
          "r"(bar_addr) : "memory");
    }
  }
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin > (1ll << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_addr) : "memory");
  }
  const int64_t nvec = embed >> 2;
  for (int64_t c = lane; c < nvec; c += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) store_vec(dst + r * stride + 4 * c, stage[warp][r][c]);
    }
  }
}
'''

_ROWS = "constexpr int kRows = 4;"
_WARPS = "constexpr int kWarps = 8;"


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"{old!r} occurs {text.count(old)} times")
    return text.replace(old, new)


def _bulk(text: str) -> str:
    start = text.index(_COPY_ROWS_START)
    end = text.index("\n}\n", start) + 3
    return text[:start] + _BULK_COPY_ROWS + text[end:]


#: Variant name -> how it is made from the package source.
VARIANTS = {
    "rows1": lambda t: _replace(t, _ROWS, "constexpr int kRows = 1;"),
    "rows2": lambda t: _replace(t, _ROWS, "constexpr int kRows = 2;"),
    "rows8": lambda t: _replace(t, _ROWS, "constexpr int kRows = 8;"),
    "warps4": lambda t: _replace(t, _WARPS, "constexpr int kWarps = 4;"),
    "rows8_warps4": lambda t: _replace(
        _replace(t, _ROWS, "constexpr int kRows = 8;"), _WARPS,
        "constexpr int kWarps = 4;"),
    "ldg": lambda t: _replace(
        _replace(t, _LOAD_ONCE, "  return __ldg(p);\n"), _POLICY,
        "  uint64_t policy = 0;\n"),
    "l1_only": lambda t: _replace(t, _LOAD_ONCE, _LOAD_ONCE.replace(
        ".L2::cache_hint", "").replace("[%4], %5;", "[%4];").replace(
        ', "l"(policy)', "")),
    "unrolled": lambda t: _replace(t, "#pragma unroll 1\n", ""),
    "bulk": _bulk,
}


def _bind(path: str, parent: bool) -> ctypes.CDLL:
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    lib = ctypes.CDLL(path)
    lib.rsdl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rsdl_cuda_error_string.restype = ctypes.c_char_p
    if parent:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rsdl_gather_rows.argtypes = [p, p, i, p, i, i64, i64, i64, p]
        lib.rsdl_gather_rows.restype = i
    else:
        build._bind_gather(lib)
    return lib


def _parent_launches(lib, tables, indices, dtype):
    """8 one-table launches of the parent's kernel (bf16 out, int32 ids)."""
    stream = torch.cuda.current_stream().cuda_stream
    for table, idx in zip(tables, indices):
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=dtype,
                          device="cuda")
        rc = lib.rsdl_gather_rows(table.data_ptr(), idx.data_ptr(), 2,
                                  out.data_ptr(), 1, idx.shape[0],
                                  table.shape[0], table.shape[1], stream)
        if rc != 0:
            raise RuntimeError(f"parent launch failed (cudaError {rc})")


def main(parent_source: str | None) -> int:
    if not torch.cuda.is_available():
        print("chip_gather_ab: CUDA is not available", file=sys.stderr)
        return 1
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb

    print(cs.nvidia_smi_line(), flush=True)
    with open(build.GATHER_SOURCE) as f:
        package = f.read()
    scratch = tempfile.mkdtemp(prefix="rsdl-gather-ab-")
    sources = {"package": build.GATHER_SOURCE}
    for name, make in VARIANTS.items():
        sources[name] = os.path.join(scratch, f"gather_{name}.cu")
        with open(sources[name], "w") as f:
            f.write(make(package))
    one_table = None  # the variant with the one-table interface, if any
    if parent_source:
        sources["parent"] = parent_source
        with open(parent_source) as f:
            if "RsdlGatherArgs" not in f.read():
                one_table = "parent"
    try:
        with cf.ThreadPoolExecutor(max_workers=len(sources)) as pool:
            futures = {name: pool.submit(build._compile,
                                         f"rsdl_torch_gather_{name}", src)
                       for name, src in sources.items()}
    finally:
        shutil.rmtree(scratch)
    libs = {}
    for name, future in futures.items():
        try:
            libs[name] = _bind(future.result(), name == one_table)
        except RuntimeError as exc:
            cs.emit({"build": name, "error": str(exc)[-3000:]})
            continue
        info = build.PTXAS_INFO.get(f"rsdl_torch_gather_{name}", "")
        cs.emit({"build": name, "ok": True,
                 "ptxas": cs.ptxas_by_kernel(info) if info else None})

    g = torch.Generator(device="cuda").manual_seed(7)
    tables, idx_sets = cs.main_path_group(emb, g)
    # Shapes timed: the DLRM step's group, and its largest table alone at
    # the loader's batch (a launch of many waves).
    big = max(tables, key=lambda t: t.shape[0])
    shapes = {
        "group8_B2048": ([(tables, i, torch.bfloat16) for i in idx_sets],
                         200),
        "one_B131072": ([([big], [torch.randint(
            0, big.shape[0], (cs.BATCHES[-1],), device="cuda",
            dtype=torch.int32, generator=g)], torch.bfloat16)
            for _ in range(4)], 20)}
    peak = cs.hbm_peak(torch.cuda.get_device_name(0))
    package_lib = build.gather_library()
    timed = {}
    try:
        for name, lib in libs.items():
            if name == one_table:
                timed[name] = lambda t, i, d, lib=lib: _parent_launches(
                    lib, t, i, d)
                continue
            build._libs["rsdl_torch_gather"] = lib
            try:
                cs._check_grouped(emb, "main path", tables, idx_sets[0],
                                  torch.bfloat16)
                cs._mixed_group_checks(emb, g)
            except (AssertionError, RuntimeError) as exc:
                cs.emit({"check": name, "error": str(exc)})
                continue
            cs.emit({"check": name, "ok": True})
            timed[name] = emb.gather_rows_grouped
        order = list(timed)
        for shape, (args, iters) in shapes.items():
            bound_ms = cs.group_bytes(*args[0]) / peak * 1e3
            for turn, names in enumerate((order, order[::-1])):
                ms = {}
                for name in names:
                    if name != one_table:
                        build._libs["rsdl_torch_gather"] = libs[name]
                    ms[name] = cs.device_ms(timed[name], args, iters)
                cs.emit({"shape": shape, "turn": turn, "bound_ms": bound_ms,
                         "ms": ms, "bound_share": {
                             n: bound_ms / t for n, t in ms.items()}})
    finally:
        build._libs["rsdl_torch_gather"] = package_lib
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1] if len(sys.argv) == 2 else None))
