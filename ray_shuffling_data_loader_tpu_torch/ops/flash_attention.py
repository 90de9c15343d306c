"""Flash attention: blockwise online softmax in hand-written Hopper kernels.

Counterpart of the JAX package's ``ops/flash_attention.py``. Layout
``(B, H, S, D)``; an optional additive key-side bias ``(B, 1, 1, Sk)``
(any other shape raises). Three CUDA kernels in
``kernels/flash_attention.cu`` port the three Pallas kernels:

- ``flash_fwd``: ``out = softmax(q kᵀ / sqrt(D) + bias) v`` and the f32
  per-query logsumexp ``lse``, never materialising the scores;
- ``flash_dq``: ``dq = scale * sum_k ds k`` with ``p = exp(s - lse)`` and
  ``ds = p * (dO vᵀ - delta)``;
- ``flash_dkv``: ``dv = sum_q pᵀ dO``, ``dk = scale * sum_q dsᵀ q`` and the
  per-head ``dbias = sum_q ds``.

``delta = rowsum(dO * O)`` is computed in f32 outside the kernels, and the
per-head ``dbias`` is summed over heads outside them, as in the JAX
package. ``lse`` may be global, covering more keys than ``k`` (ring
attention's per-hop backward relies on this).

Each kernel wrapper launches its kernel on CUDA tensors (bf16, head dim in
``SUPPORTED_HEAD_DIMS``) or raises. The public functions take the plain
PyTorch versions (``flash_*_reference``: scores materialised, exact softmax,
f32) only for CPU tensors. The TPU tile plan (block sizes, (8, 128)
padding, interpret mode) has no counterpart: the kernels mask ragged edges
themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device

_NEG = -1e30   # running-max init of the online softmax

#: Head dims the CUDA kernels are built for.
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

#: The JAX package's TPU threshold for taking flash over inline attention,
#: kept as the dispatch rule of :func:`auto_attention_fn`; it is not an
#: H100 measurement.
FLASH_MIN_SEQ_LEN = 1024

#: Kernel launches, by kernel name. Each wrapper adds one where it launches
#: its kernel and nowhere else; ``reset_launch_counts`` zeroes them.
launch_counts = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def _check_bias(bias: Optional[torch.Tensor], b: int, sk: int) -> None:
    if bias is not None and tuple(bias.shape) != (b, 1, 1, sk):
        raise ValueError(
            f"flash_attention bias must be key-side (B, 1, 1, S) = "
            f"{(b, 1, 1, sk)}, got {tuple(bias.shape)}; full (.., S, S) "
            "biases (e.g. causal masks) are not supported by this kernel")


def _lse3(lse: torch.Tensor) -> torch.Tensor:
    """``(B, H, Sq)`` or ``(B, H, Sq, 1)`` -> ``(B, H, Sq)``."""
    return lse[..., 0] if lse.dim() == 4 else lse


def _scores(q, k, bias):
    """f32 ``q kᵀ * scale + bias`` (the backward kernels' form)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    return s


# -- plain PyTorch versions (CPU path and the card's checks) -----------------


def flash_forward_reference(q, k, v, bias=None):
    """Plain ``(out, lse)``: scores materialised in f32, exact softmax.
    ``out`` in q's dtype, ``lse`` ``(B, H, Sq, 1)`` f32."""
    _check_bias(bias, q.shape[0], k.shape[2])
    s = torch.matmul(q.float() * _scale(q.shape[-1]),
                     k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def _probs_and_ds(q, k, v, bias, do, lse, delta):
    p = torch.exp(_scores(q, k, bias) - _lse3(lse).float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.float()[..., None])


def flash_dq_reference(q, k, v, bias, do, lse, delta):
    """Plain ``dq`` (q's dtype) from the flash residuals; ``delta`` is
    ``(B, H, Sq)`` f32."""
    _, ds = _probs_and_ds(q, k, v, bias, do, lse, delta)
    return (torch.matmul(ds, k.float()) * _scale(q.shape[-1])).to(q.dtype)


def flash_dkv_reference(q, k, v, bias, do, lse, delta):
    """Plain ``(dk, dv, dbias_per_head)``: dk/dv in k's/v's dtype, the
    per-head dbias ``(B, H, 1, Sk)`` f32, or None without a bias."""
    p, ds = _probs_and_ds(q, k, v, bias, do, lse, delta)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * _scale(q.shape[-1])
    dbias = None if bias is None else ds.sum(dim=2, keepdim=True)
    return dk.to(k.dtype), dv.to(v.dtype), dbias


# -- CUDA kernel wrappers ----------------------------------------------------


def _check_cuda_inputs(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} needs every tensor on one CUDA device; "
                             f"{arg} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors; {arg} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors; {arg} "
                             "is not")


def _check_qkv(name: str, q, k, v, *others) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} needs q (B, H, Sq, D) and k, v (B, H, Sk, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for t in (q, k, v) + others:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes bfloat16 q, k, v (and dO), got "
                             f"{t.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} supports head dims {SUPPORTED_HEAD_DIMS}, "
                         f"got {d}")
    return b, h, sq, k.shape[2], d


def _f32_rows(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` (lse or delta) as a contiguous f32 tensor of ``shape``."""
    return t.reshape(shape).float().contiguous()


def _raise_on(name: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.rsdl_cuda_error_string(rc).decode()}"
            f" (cudaError {rc})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _bias_ptr(bias: Optional[torch.Tensor]) -> Optional[int]:
    return None if bias is None else bias.data_ptr()


def _prep_bias_cuda(bias, b: int, sk: int) -> Optional[torch.Tensor]:
    _check_bias(bias, b, sk)
    return None if bias is None else bias.float().contiguous()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ``(out bf16 (B, H, Sq, D), lse f32
    (B, H, Sq, 1))``. q, k, v contiguous bf16 on one CUDA device."""
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    b, h, sq, sk, d = _check_qkv("flash_fwd", q, k, v)
    bias = _prep_bias_cuda(bias, b, sk)
    tensors = dict(q=q, k=k, v=v)
    if bias is not None:
        tensors["bias"] = bias
    _check_cuda_inputs("flash_fwd", q.device, **tensors)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_fwd needs at least one key")
    lib = build.flash_library()
    rc = lib.rsdl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias),
        out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, _scale(d),
        _stream(q.device))
    _raise_on("flash_fwd", lib, rc)
    launch_counts["flash_fwd"] += 1
    return out, lse


def flash_dq(q, k, v, bias, do, lse, delta) -> torch.Tensor:
    """Launch the dq kernel: ``dq`` bf16 ``(B, H, Sq, D)``. ``lse`` and
    ``delta`` are f32 ``(B, H, Sq)`` (or with a trailing 1)."""
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    b, h, sq, sk, d = _check_qkv("flash_dq", q, k, v, do)
    bias = _prep_bias_cuda(bias, b, sk)
    if do.shape != q.shape:
        raise ValueError(f"flash_dq: dO {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    lse = _f32_rows(lse, (b, h, sq))
    delta = _f32_rows(delta, (b, h, sq))
    tensors = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    if bias is not None:
        tensors["bias"] = bias
    _check_cuda_inputs("flash_dq", q.device, **tensors)
    dq = torch.empty_like(q)
    if b * h * sq == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    lib = build.flash_library()
    rc = lib.rsdl_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, h, sq, sk, d, _scale(d), _stream(q.device))
    _raise_on("flash_dq", lib, rc)
    launch_counts["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, bias, do, lse, delta):
    """Launch the dk/dv kernel: ``(dk, dv, dbias_per_head)``, dk/dv bf16
    ``(B, H, Sk, D)``, dbias f32 ``(B, H, 1, Sk)`` with a bias, else
    None."""
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    b, h, sq, sk, d = _check_qkv("flash_dkv", q, k, v, do)
    bias = _prep_bias_cuda(bias, b, sk)
    if do.shape != q.shape:
        raise ValueError(f"flash_dkv: dO {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    lse = _f32_rows(lse, (b, h, sq))
    delta = _f32_rows(delta, (b, h, sq))
    tensors = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    if bias is not None:
        tensors["bias"] = bias
    _check_cuda_inputs("flash_dkv", q.device, **tensors)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = None
    if bias is not None:
        dbias = torch.empty((b, h, 1, sk), dtype=torch.float32,
                            device=q.device)
    if b * h * sk == 0:
        return dk, dv, dbias
    if sq == 0:
        for t in (dk, dv, dbias):
            if t is not None:
                t.zero_()
        return dk, dv, dbias
    lib = build.flash_library()
    rc = lib.rsdl_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if dbias is None else dbias.data_ptr(),
        b, h, sq, sk, d, _scale(d), _stream(q.device))
    _raise_on("flash_dkv", lib, rc)
    launch_counts["flash_dkv"] += 1
    return dk, dv, dbias


# -- public API (JAX package names) ------------------------------------------


def flash_forward(q, k, v, bias=None):
    """``(out, lse)`` with lse ``(B, H, Sq, 1)`` f32: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, bias)
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), bias)


def flash_backward(q, k, v, bias, out, lse, do):
    """``(dq, dk, dv, dbias)`` from the flash residuals. ``lse`` may be
    ``(B, H, Sq)`` or ``(B, H, Sq, 1)`` and may be global (covering more
    keys than ``k``). ``dbias`` is the per-head dbias summed over heads in
    the bias's dtype, or None without a bias."""
    _check_bias(bias, q.shape[0], k.shape[2])
    # delta_i = sum_d do_i * o_i, the softmax-backward correction term.
    delta = (do.float() * out.float()).sum(dim=-1)
    lse = _lse3(lse)
    if q.device.type == "cpu":
        dq = flash_dq_reference(q, k, v, bias, do, lse, delta)
        dk, dv, dbias_h = flash_dkv_reference(q, k, v, bias, do, lse, delta)
    else:
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
        dq = flash_dq(q, k, v, bias, do, lse, delta)
        dk, dv, dbias_h = flash_dkv(q, k, v, bias, do, lse, delta)
    dbias = None
    if dbias_h is not None:
        dbias = dbias_h.sum(dim=1, keepdim=True).to(bias.dtype)
    return dq, dk, dv, dbias


class FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_forward`, saving ``q, k, v, bias, out, lse``.
    Backward: :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_forward(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        return flash_backward(q, k, v, bias, out, lse, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention through the flash kernels, differentiable in q, k,
    v and bias. q, k, v ``(B, H, S, D)``; bias ``(B, 1, 1, S)`` or None."""
    _check_bias(bias, q.shape[0], k.shape[2])
    return FlashAttention.apply(q, k, v, bias)


def make_flash_attention_fn():
    """An ``attention_fn(q, k, v, bias)`` for ``models/bert.py``."""

    def attention_fn(q, k, v, bias=None):
        return flash_attention(q, k, v, bias)

    return attention_fn


def auto_attention_fn(seq_len: int, device=None):
    """The JAX package's rule: the flash ``attention_fn`` on CUDA when
    ``seq_len >= FLASH_MIN_SEQ_LEN``, else None (the model's inline
    attention). ``device=None`` means CUDA and raises without it."""
    if (resolve_device(device).type == "cuda"
            and seq_len >= FLASH_MIN_SEQ_LEN):
        return make_flash_attention_fn()
    return None
