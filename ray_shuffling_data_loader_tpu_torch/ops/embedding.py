"""Embedding lookup strategies for DLRM-style sparse features.

Counterpart of ``ray_shuffling_data_loader_tpu/ops/embedding.py``.
:func:`lookup` has four modes, all of which clamp out-of-range indices to
``[0, V-1]`` and return bit-identical results:

- ``take``: ``index_select`` on clamped indices (cast, then gather). JAX's
  ``jnp.take(mode="clip")`` clamps, but torch raises on an out-of-range
  index, so the clamp is explicit.
- ``one_hot``: ``(B, V)`` one-hot times the table. Exact: each output row
  is 1.0 times one table row.
- ``kernel``: the hand-written CUDA row gather ``kernels/gather.cu``
  (the port of the Pallas ``_pallas_gather_impl``) wrapped in a
  ``torch.autograd.Function``. On a CPU tensor it runs
  :func:`gather_reference`, its plain PyTorch version; on a CUDA tensor it
  launches the kernel or raises. The kernel takes a group of tables in one
  launch (:func:`gather_rows_grouped`); :func:`lookup_features` sends
  every table of a model that resolves to ``kernel`` through one such
  launch.
- ``auto``: vocab <= ``ONE_HOT_MAX_VOCAB`` goes to ``one_hot``; above it,
  ``kernel`` on CUDA and ``take`` on the CPU. This keeps the JAX package's
  dispatch rule; no timing from the TPU carries over.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ray_shuffling_data_loader_tpu_torch.kernels import build

# The JAX package's dispatch threshold, kept so both packages route each
# table through the same arithmetic (not a measured H100 optimum).
ONE_HOT_MAX_VOCAB = 2048

_IDX_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, by kernel name. Each wrapper adds one where it launches
#: its kernel and nowhere else; ``reset_launch_counts`` zeroes them.
launch_counts = {"gather_rows": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _clamped(indices: torch.Tensor, vocab: int) -> torch.Tensor:
    return indices.long().clamp(0, vocab - 1)


def gather_reference(table: torch.Tensor, indices: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: gather in the table's
    dtype, then cast (the order of the Pallas path; both orders are exact).
    """
    return table.index_select(0, _clamped(indices, table.shape[0])).to(dtype)


def gather_grouped_reference(tables: Sequence[torch.Tensor],
                             indices: Sequence[torch.Tensor],
                             dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the grouped gather: :func:`gather_reference`
    per table, stacked to ``(G, B, E)``."""
    return torch.stack([gather_reference(t, i, dtype)
                        for t, i in zip(tables, indices)])


def _check_group(tables: Sequence[torch.Tensor],
                 indices: Sequence[torch.Tensor], dtype: torch.dtype) -> None:
    if not 1 <= len(tables) <= build.GATHER_MAX_GROUPS \
            or len(indices) != len(tables):
        raise ValueError(
            f"gather_rows takes 1 to {build.GATHER_MAX_GROUPS} tables with "
            f"one index tensor each, got {len(tables)} tables and "
            f"{len(indices)} index tensors")
    if dtype not in _OUT_CODES:
        raise ValueError(f"gather_rows outputs float32 or bfloat16, not "
                         f"{dtype}")
    for table, idx in zip(tables, indices):
        if table.dtype != torch.float32 or table.ndim != 2 \
                or not table.is_contiguous() or table.shape[0] < 1:
            raise ValueError(
                f"gather_rows needs non-empty contiguous 2-D float32 tables, "
                f"got {table.dtype} {tuple(table.shape)}")
        if idx.dtype not in _IDX_CODES or idx.ndim != 1 \
                or not idx.is_contiguous():
            raise ValueError(
                f"gather_rows needs contiguous 1-D int8/16/32/64 indices, "
                f"got {idx.dtype} {tuple(idx.shape)}")
        if table.shape[1] != tables[0].shape[1] \
                or idx.shape != indices[0].shape:
            raise ValueError(
                f"gather_rows needs one width and one batch for the whole "
                f"group, got width {table.shape[1]} and batch {idx.shape[0]} "
                f"beside {tables[0].shape[1]} and {indices[0].shape[0]}")
    device = tables[0].device
    if device.type != "cuda" or any(t.device != device
                                    for t in (*tables, *indices)):
        raise ValueError(
            f"gather_rows needs every table and index tensor on one CUDA "
            f"device, got "
            f"{sorted({str(t.device) for t in (*tables, *indices)})}")


def gather_rows_grouped(tables: Sequence[torch.Tensor],
                        indices: Sequence[torch.Tensor], dtype: torch.dtype,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA gather kernel once for a group of tables:
    ``out[g] = cast(tables[g][clamp(indices[g])])``.

    ``tables``: 1 to ``GATHER_MAX_GROUPS`` contiguous f32 ``(V_g, E)``
    tables on one CUDA device; ``indices``: one contiguous 1-D
    int8/16/32/64 tensor of length B per table (dtypes may differ);
    ``dtype`` f32 or bf16. Returns ``out``, a ``(G, B, E)`` tensor
    allocated here unless given (then any strides with the last one 1).
    Launches on the current stream; raises on any input the kernel does
    not take and on a refused launch.
    """
    _check_group(tables, indices, dtype)
    device = tables[0].device
    groups, batch, embed = len(tables), indices[0].shape[0], tables[0].shape[1]
    if out is None:
        out = torch.empty((groups, batch, embed), dtype=dtype, device=device)
    elif (out.shape != (groups, batch, embed) or out.dtype != dtype
          or out.device != device or out.stride(2) != 1):
        raise ValueError(
            f"gather_rows needs out of shape {(groups, batch, embed)}, dtype "
            f"{dtype} on {device} with unit stride in its last dimension")
    if batch == 0:
        return out
    args = build.GatherArgs(batch=batch, embed=embed, num_groups=groups,
                            out_code=_OUT_CODES[dtype])
    out_ptr, out_step = out.data_ptr(), out.stride(0) * out.element_size()
    for g, (table, idx) in enumerate(zip(tables, indices)):
        desc = args.group[g]  # fields set in place: the host cost counts
        desc.table, desc.idx = table.data_ptr(), idx.data_ptr()
        desc.out, desc.out_stride = out_ptr + g * out_step, out.stride(1)
        desc.vocab, desc.idx_code = table.shape[0], _IDX_CODES[idx.dtype]
    lib = build.gather_library()
    rc = lib.rsdl_gather_rows(ctypes.byref(args),
                              torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_rows launch failed: "
            f"{lib.rsdl_cuda_error_string(rc).decode()} (cudaError {rc})")
    launch_counts["gather_rows"] += 1
    return out


def gather_rows(table: torch.Tensor, indices: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The gather kernel for one table (a group of one):
    ``cast(table[clamp(idx)])`` as a ``(B, E)`` tensor."""
    return gather_rows_grouped([table], [indices], dtype)[0]


def _table_grad(vocab: int, table_dtype: torch.dtype, indices: torch.Tensor,
                grad_out: torch.Tensor) -> torch.Tensor:
    """Dense scatter-add of the cotangent rows into ``zeros(V, E)`` in the
    table's dtype, the counterpart of the JAX package's
    ``_pallas_gather_bwd`` (an XLA scatter-add there too, outside the
    kernel)."""
    grad = torch.zeros((vocab, grad_out.shape[1]), dtype=table_dtype,
                       device=grad_out.device)
    grad.index_add_(0, _clamped(indices, vocab), grad_out.to(table_dtype))
    return grad


def table_grad_reference(vocab: int, indices: torch.Tensor,
                         grad_out: torch.Tensor):
    """Plain check of :func:`_table_grad` at repeated (and clamped) ids,
    whose atomics add in no fixed order: ``(want, bound)``, the f64 sum of
    the cotangent rows per table row and the largest error of an f32
    accumulation of them in any order, ``(m - 1) * u * sum |x|`` with ``m``
    the rows landing on that row and ``u`` f32's unit roundoff (the first
    add into zero is exact)."""
    idx = _clamped(indices, vocab)
    rows = grad_out.to(torch.float32).double()
    zeros = torch.zeros((vocab, rows.shape[1]), dtype=torch.float64,
                        device=rows.device)
    want = zeros.index_add(0, idx, rows)
    abs_sum = zeros.index_add(0, idx, rows.abs())
    hits = torch.zeros(vocab, dtype=torch.float64, device=rows.device)
    hits.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))
    u = torch.finfo(torch.float32).eps / 2
    bound = (hits - 1).clamp(min=0)[:, None] * u * abs_sum
    return want, bound


class KernelGather(torch.autograd.Function):
    """Forward: the CUDA gather kernel. Backward: :func:`_table_grad`."""

    @staticmethod
    def forward(ctx, table, indices, dtype):
        ctx.save_for_backward(indices)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        return gather_rows(table, indices, dtype)

    @staticmethod
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        return _table_grad(ctx.vocab, ctx.table_dtype, indices,
                           grad_out), None, None


class KernelGatherGroup(torch.autograd.Function):
    """Forward: one launch of the CUDA gather kernel for G tables, output
    ``(G, B, E)``. Backward: :func:`_table_grad` per table, as
    :class:`KernelGather`. Called as ``apply(dtype, *tables, *indices)``."""

    @staticmethod
    def forward(ctx, dtype, *tensors):
        tables, indices = tensors[:len(tensors) // 2], \
            tensors[len(tensors) // 2:]
        ctx.save_for_backward(*indices)
        ctx.tables = [(t.shape[0], t.dtype) for t in tables]
        return gather_rows_grouped(tables, indices, dtype)

    @staticmethod
    def backward(ctx, grad_out):
        grads = [_table_grad(vocab, table_dtype, idx, grad)
                 for (vocab, table_dtype), idx, grad in zip(
                     ctx.tables, ctx.saved_tensors, grad_out)]
        return (None, *grads, *([None] * len(grads)))


def kernel_lookup(table: torch.Tensor, indices: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The gather kernel on CUDA tensors, its plain version on CPU ones."""
    if table.device.type == "cpu":
        return gather_reference(table, indices, dtype)
    return KernelGather.apply(table, indices.contiguous(), dtype)


def kernel_lookup_grouped(tables: Sequence[torch.Tensor],
                          indices: Sequence[torch.Tensor],
                          dtype: torch.dtype) -> torch.Tensor:
    """:func:`kernel_lookup` for a group of tables in one launch:
    ``(G, B, E)``."""
    if tables[0].device.type == "cpu":
        return gather_grouped_reference(tables, indices, dtype)
    return KernelGatherGroup.apply(dtype, *tables,
                                   *(i.contiguous() for i in indices))


def take_lookup(table: torch.Tensor, indices: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return table.to(dtype).index_select(0, _clamped(indices, table.shape[0]))


def one_hot_lookup(table: torch.Tensor, indices: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    vocab = table.shape[0]
    one_hot = F.one_hot(_clamped(indices, vocab), vocab).to(dtype)
    return one_hot @ table.to(dtype)


def _auto_mode(table: torch.Tensor) -> str:
    if table.shape[0] <= ONE_HOT_MAX_VOCAB:
        return "one_hot"
    return "kernel" if table.device.type == "cuda" else "take"


def lookup(table: torch.Tensor, indices: torch.Tensor, dtype: torch.dtype,
           mode: str = "auto") -> torch.Tensor:
    """Embedding lookup: ``table (V, E)``, ``indices (B,)`` -> ``(B, E)``
    in ``dtype``."""
    if mode == "auto":
        mode = _auto_mode(table)
    if mode == "take":
        return take_lookup(table, indices, dtype)
    if mode == "one_hot":
        return one_hot_lookup(table, indices, dtype)
    if mode == "kernel":
        return kernel_lookup(table, indices, dtype)
    raise ValueError(
        f"unknown lookup mode {mode!r}; expected auto/take/one_hot/kernel")


def lookup_features(tables: Sequence[torch.Tensor],
                    indices: Sequence[torch.Tensor], dtype: torch.dtype,
                    mode: str = "auto") -> List[torch.Tensor]:
    """:func:`lookup` of ``indices[i]`` in ``tables[i]`` for every feature,
    in feature order. The tables whose mode resolves to ``kernel`` are
    gathered together, one launch for up to ``GATHER_MAX_GROUPS`` of them
    (they share E and B); the rest go through :func:`lookup`."""
    modes = [_auto_mode(t) if mode == "auto" else mode for t in tables]
    vectors: List[Optional[torch.Tensor]] = [
        None if m == "kernel" else lookup(t, i, dtype, mode=m)
        for t, i, m in zip(tables, indices, modes)]
    routed = [f for f, m in enumerate(modes) if m == "kernel"]
    for s in range(0, len(routed), build.GATHER_MAX_GROUPS):
        chunk = routed[s:s + build.GATHER_MAX_GROUPS]
        out = kernel_lookup_grouped([tables[f] for f in chunk],
                                    [indices[f] for f in chunk], dtype)
        for f, vector in zip(chunk, out.unbind(0)):
            vectors[f] = vector
    return vectors
