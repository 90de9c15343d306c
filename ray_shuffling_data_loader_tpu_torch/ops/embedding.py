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
  launches the kernel or raises.
- ``auto``: vocab <= ``ONE_HOT_MAX_VOCAB`` goes to ``one_hot``; above it,
  ``kernel`` on CUDA and ``take`` on the CPU. This keeps the JAX package's
  dispatch rule; no timing from the TPU carries over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def gather_rows(table: torch.Tensor, indices: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA gather kernel: ``cast(table[clamp(idx)])``.

    ``table`` f32 ``(V, E)`` contiguous on a CUDA device, ``indices`` a
    contiguous 1-D int8/16/32/64 tensor on the same device, ``dtype`` f32
    or bf16. Launches on the current stream; raises on any input the kernel
    does not take and on a refused launch.
    """
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    if table.device.type != "cuda" or indices.device != table.device:
        raise ValueError(
            f"gather_rows needs table and indices on one CUDA device, got "
            f"{table.device} and {indices.device}")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(
            f"gather_rows needs a contiguous 2-D float32 table, got "
            f"{table.dtype} {tuple(table.shape)}")
    if indices.dtype not in _IDX_CODES or indices.dim() != 1 \
            or not indices.is_contiguous():
        raise ValueError(
            f"gather_rows needs contiguous 1-D int8/16/32/64 indices, got "
            f"{indices.dtype} {tuple(indices.shape)}")
    if dtype not in _OUT_CODES:
        raise ValueError(f"gather_rows outputs float32 or bfloat16, not "
                         f"{dtype}")
    vocab, embed = table.shape
    if vocab < 1:
        raise ValueError("gather_rows needs a non-empty table")
    batch = indices.shape[0]
    out = torch.empty((batch, embed), dtype=dtype, device=table.device)
    if batch == 0:
        return out
    lib = build.gather_library()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.rsdl_gather_rows(
        table.data_ptr(), indices.data_ptr(), _IDX_CODES[indices.dtype],
        out.data_ptr(), _OUT_CODES[dtype], batch, vocab, embed, stream)
    if rc != 0:
        raise RuntimeError(
            f"gather_rows launch failed: "
            f"{lib.rsdl_cuda_error_string(rc).decode()} (cudaError {rc})")
    launch_counts["gather_rows"] += 1
    return out


class KernelGather(torch.autograd.Function):
    """Forward: the CUDA gather kernel. Backward: dense scatter-add of the
    cotangent rows into ``zeros(V, E)`` in the table's dtype, the
    counterpart of the JAX package's ``_pallas_gather_bwd`` (an XLA
    scatter-add there too, outside the kernel)."""

    @staticmethod
    def forward(ctx, table, indices, dtype):
        ctx.save_for_backward(indices)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        return gather_rows(table, indices, dtype)

    @staticmethod
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        grad = torch.zeros((ctx.vocab, grad_out.shape[1]),
                           dtype=ctx.table_dtype, device=grad_out.device)
        grad.index_add_(0, _clamped(indices, ctx.vocab),
                        grad_out.to(ctx.table_dtype))
        return grad, None, None


def kernel_lookup(table: torch.Tensor, indices: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The gather kernel on CUDA tensors, its plain version on CPU ones."""
    if table.device.type == "cpu":
        return gather_reference(table, indices, dtype)
    return KernelGather.apply(table, indices.contiguous(), dtype)


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
