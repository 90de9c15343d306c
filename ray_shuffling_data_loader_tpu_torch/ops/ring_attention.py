"""Sequence-parallel attention: ring attention and Ulysses (counterpart of
the JAX package's ``ops/ring_attention.py``).

Both compute exact softmax attention for a sequence split over the ``seq``
axis of a mesh (``parallel.mesh``). There is no global array in PyTorch:
each rank passes its chunk ``(B_local, H, S/n, D)`` (and the key-side bias
chunk ``(B_local, 1, 1, S/n)``) and gets its chunk of the output back. The
rank's coordinate on the axis gives the chunk's global offset.

- :func:`ring_self_attention`: K/V (and the key-side bias) rotate one hop
  per step with ``batch_isend_irecv`` to the next rank of the ring; after
  ``i`` rotations a rank holds chunk ``(my - i) mod n``. Hops merge by an
  online softmax (einsum) or by logsumexp (flash). The backward pass is an
  explicit ring (an autograd ``Function``): it recomputes each hop from
  ``(q, k, v, bias, out, lse)``, and the dk/dv (and dbias) accumulators
  travel with their chunks and arrive home after ``n`` hops.
- :func:`ulysses_attention`: two ``all_to_all_single`` calls reshard from
  sequence-split to head-split and back, around full-sequence attention
  for ``H/n`` heads; the key-side bias is all-gathered.

With ``use_flash`` each hop (and each Ulysses shard) runs
``ops.flash_attention``: the hand-written Hopper kernels on CUDA tensors,
their plain versions on CPU tensors. The flash bias is key-side only, so
flash with ``causal=True`` raises. Scores and accumulators are float32;
masking uses a large finite negative so fully masked rows stay finite.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as fa
from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh

NEG_INF = -1e9  # finite, like models/bert.py: keeps the softmax NaN-free
_ACC_MIN = -1e30

Tensors = Tuple[Optional[torch.Tensor], ...]


def causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """``(1, 1, Sq, Sk)`` additive causal mask from global positions."""
    return torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                       NEG_INF).to(torch.float32)[None, None]


# -- the ring: who holds which chunk ------------------------------------------


class _ProcessRing:
    """The ``seq`` axis of a mesh as a ring of processes: a rotation sends
    to rank ``index + 1`` and receives from rank ``index - 1`` (mod n)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.index = pmesh.axis_index(mesh, axis)
        self._next = dist.get_global_rank(self.group,
                                          (self.index + 1) % self.size)
        self._prev = dist.get_global_rank(self.group,
                                          (self.index - 1) % self.size)

    def rotate(self, key: str, tensors: Tensors) -> Callable[[], Tensors]:
        """Start sending ``tensors`` (Nones stay None) on; returns a
        function that waits and gives the previous rank's. ``key`` names
        the stream (K/V or gradients); the process ring needs no name."""
        if self.size == 1:
            return lambda: tensors
        live = [t.contiguous() for t in tensors if t is not None]
        recv = [torch.empty_like(t) for t in live]
        ops = ([dist.P2POp(dist.isend, t, self._next, self.group)
                for t in live]
               + [dist.P2POp(dist.irecv, t, self._prev, self.group)
                  for t in recv])
        requests = dist.batch_isend_irecv(ops)

        def wait() -> Tensors:
            for r in requests:
                r.wait()
            it = iter(recv)
            return tuple(None if t is None else next(it) for t in tensors)

        return wait


class _LocalRing:
    """A ring pass of rank ``index`` over ``n`` K/V chunks held in this
    process, as if the other ranks held no queries: a rotation is a step
    back along the list. An accumulator arriving from a chunk not yet
    visited is zeros; the one stored at a chunk stays there. Good for one
    ring pass."""

    def __init__(self, index: int, chunks: Sequence[Tensors]):
        self.size, self.index = len(chunks), index
        self._slots = {"kv": list(chunks)}
        self._at = {}

    def rotate(self, key: str, tensors: Tensors) -> Callable[[], Tensors]:
        slots = self._slots.setdefault(key, [None] * self.size)
        at = self._at.get(key, self.index)
        slots[at] = tensors
        at = self._at[key] = (at - 1) % self.size
        if slots[at] is None:
            slots[at] = tuple(None if t is None else torch.zeros_like(t)
                              for t in tensors)
        return lambda: slots[at]

    def stored(self, key: str) -> List[Tensors]:
        return self._slots[key]


# -- per-hop math -------------------------------------------------------------


def _block_attention(q, k, v, bias, m, l, o):
    """One online-softmax step against a K/V block: q ``(B, H, Sq, D)`` f32
    (pre-scaled), bias broadcastable to ``(B, H, Sq, Sk)`` f32 or None; the
    running max m and denominator l ``(B, H, Sq)`` and o ``(B, H, Sq, D)``
    are f32."""
    scores = torch.matmul(q, k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _block_grads(qf, dof, k, v, bias, lse, delta, scale: float,
                 with_dbias: bool):
    """One hop's ``(dq, dk, dv, dbias)`` in f32 by the flash identities,
    recomputing the softmax weights from the global ``lse``."""
    kf, vf = k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dbias = ds.sum(dim=(1, 2))[:, None, None, :] if with_dbias else None
    return dq, dk, dv, dbias


def _hop_bias(causal: bool, bias, my: int, src: int, sq: int, sk: int,
              device):
    if not causal:
        return bias
    cb = causal_bias(my * sq + torch.arange(sq, device=device),
                     src * sk + torch.arange(sk, device=device))
    return cb if bias is None else bias + cb


def _add(acc, x):
    """``acc + x`` in f32 (``x`` is widened inside the add); ``acc`` None
    (nothing accumulated yet) gives ``x`` as it is: the JAX package's sum
    from zeros, exactly, without the zeros."""
    if x is None or acc is None:
        return x
    return acc.float() + x


def _flash_hop_forward(q, k, v, bias, o, lse):
    """One flash hop: ``flash_forward`` on the visiting chunk, merged by
    logsumexp into the running output ``o`` and ``lse`` ``(B, H, Sq)``
    (f32; None before the first hop, which then gives the state as is)."""
    out_h, lse_h = fa.flash_forward(q, k, v, bias)
    lse_h = lse_h[..., 0]
    if o is None:
        return out_h, lse_h
    lse_new = torch.logaddexp(lse, lse_h)
    o = (o.float() * torch.exp(lse - lse_new)[..., None]
         + out_h * torch.exp(lse_h - lse_new)[..., None])
    return o, lse_new


def _flash_hop_backward(q, k, v, bias, out, lse, do, dq, grads):
    """One flash hop backward with the GLOBAL ``lse``: each hop's
    recomputed weights are the global softmax restricted to its keys, so
    the per-hop kernel gradients sum exactly. Adds into ``dq`` and the
    visiting chunk's ``(dk, dv, dbias)`` accumulators (:func:`_add`)."""
    dq_h, *hop = fa.flash_backward(q, k, v, bias, out, lse, do)
    return _add(dq, dq_h), tuple(_add(a, x) for a, x in zip(grads, hop))


# -- ring passes --------------------------------------------------------------


def _chunk(k, v, kv_bias) -> Tensors:
    return (k, v, None if kv_bias is None else kv_bias.float())


def _ring_attention_fwd_impl(ring, causal: bool, q, k, v, kv_bias):
    """Forward ring pass (einsum); returns ``(out, lse)`` with ``lse`` the
    per-query logsumexp ``(B, H, Sq)``, the residual that lets the
    backward pass recompute each hop."""
    n, my = ring.size, ring.index
    sq, sk = q.shape[2], k.shape[2]
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    m = torch.full(q.shape[:3], _ACC_MIN, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    chunk = _chunk(k, v, kv_bias)
    for i in range(n):
        src = (my - i) % n
        pending = ring.rotate("kv", chunk) if i < n - 1 else None
        # Chunks wholly in this query chunk's future add nothing.
        if not (causal and src > my):
            k_c, v_c, bias_c = chunk
            bias = _hop_bias(causal, bias_c, my, src, sq, sk, q.device)
            m, l, o = _block_attention(qf, k_c, v_c, bias, m, l, o)
        if pending is not None:
            chunk = pending()
    l_safe = l.clamp(min=1e-30)
    return (o / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def _home_grads(q, k, v, kv_bias, dq, grads):
    dk, dv, dbias = grads
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None if kv_bias is None else dbias.to(kv_bias.dtype))


def _ring_attention_bwd_impl(ring, causal: bool, q, k, v, kv_bias, out,
                             lse, do):
    """Backward ring pass (einsum, recompute per hop). The dk/dv/dbias
    accumulators travel with their K/V chunks and are home after ``n``
    rotations."""
    n, my = ring.size, ring.index
    sq, sk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    # Hop 0 visits the home chunk (src == my), which causal never skips,
    # so every accumulator is set before its first rotation.
    chunk, dq, grads = _chunk(k, v, kv_bias), None, (None, None, None)
    for i in range(n):
        src = (my - i) % n
        pending = ring.rotate("kv", chunk) if i < n - 1 else None
        if not (causal and src > my):
            k_c, v_c, bias_c = chunk
            bias = _hop_bias(causal, bias_c, my, src, sq, sk, q.device)
            dq_h, *hop = _block_grads(qf, dof, k_c, v_c, bias, lse, delta,
                                      scale, kv_bias is not None)
            dq = _add(dq, dq_h)
            grads = tuple(_add(a, x) for a, x in zip(grads, hop))
        grads = ring.rotate("grads", grads)()
        if pending is not None:
            chunk = pending()
    return _home_grads(q, k, v, kv_bias, dq, grads)


def _ring_flash_fwd_impl(ring, q, k, v, kv_bias):
    """Forward ring pass where each hop runs ``flash_forward`` (the kernel
    on CUDA tensors) and hops merge by logsumexp. Non-causal only."""
    n = ring.size
    chunk, o, lse = _chunk(k, v, kv_bias), None, None
    for i in range(n):
        pending = ring.rotate("kv", chunk) if i < n - 1 else None
        o, lse = _flash_hop_forward(q, *chunk, o, lse)
        if pending is not None:
            chunk = pending()
    return o.to(q.dtype), lse


def _ring_flash_bwd_impl(ring, q, k, v, kv_bias, out, lse, do):
    """Backward ring pass through ``flash_backward`` (the dq and dk/dv
    kernels on CUDA tensors) with the global ``lse``; dk/dv/dbias ride the
    ring home with their chunks."""
    n = ring.size
    chunk, dq, grads = _chunk(k, v, kv_bias), None, (None, None, None)
    for i in range(n):
        pending = ring.rotate("kv", chunk) if i < n - 1 else None
        dq, grads = _flash_hop_backward(q, *chunk, out, lse, do, dq, grads)
        grads = ring.rotate("grads", grads)()
        if pending is not None:
            chunk = pending()
    return _home_grads(q, k, v, kv_bias, dq, grads)


def _ring_forward(ring, causal, use_flash, q, k, v, kv_bias):
    if use_flash:
        return _ring_flash_fwd_impl(ring, q, k, v, kv_bias)
    return _ring_attention_fwd_impl(ring, causal, q, k, v, kv_bias)


def _ring_backward(ring, causal, use_flash, q, k, v, kv_bias, out, lse, do):
    if use_flash:
        return _ring_flash_bwd_impl(ring, q, k, v, kv_bias, out, lse, do)
    return _ring_attention_bwd_impl(ring, causal, q, k, v, kv_bias, out,
                                    lse, do)


class _RingAttention(torch.autograd.Function):
    """Forward: one ring pass, saving only ``(q, k, v, bias, out, lse)``.
    Backward: a second ring pass (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, ring, causal, use_flash, q, k, v, kv_bias):
        out, lse = _ring_forward(ring, causal, use_flash, q, k, v, kv_bias)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.ring, ctx.causal, ctx.use_flash = ring, causal, use_flash
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        grads = _ring_backward(ctx.ring, ctx.causal, ctx.use_flash, q, k, v,
                               kv_bias, out, lse, do.contiguous())
        return (None, None, None, *grads)


def ring_walk(q, k_chunks, v_chunks, bias_chunks, do, index: int = 0,
              causal: bool = False, use_flash: bool = False):
    """Rank ``index``'s ring pass, forward and backward, over ``n`` K/V
    chunks held in this process: the loops :func:`ring_self_attention`
    runs, each rotation a step back along the lists. ``q`` holds the
    rank's queries; without ``causal``, the whole sequence with
    ``index=0`` gives whole-sequence attention. ``bias_chunks`` is None or
    one key-side bias per chunk. Returns ``(out, dq, dk, dv, dbias)`` for
    the output cotangent ``do``: dk, dv and dbias are lists over the
    chunks (dbias None without a bias)."""
    n = len(k_chunks)
    biases = [None] * n if bias_chunks is None else list(bias_chunks)
    chunks = [_chunk(k, v, b) for k, v, b in zip(k_chunks, v_chunks, biases)]
    home = (k_chunks[index], v_chunks[index], biases[index])
    out, lse = _ring_forward(_LocalRing(index, chunks), causal, use_flash,
                             q, *home)
    ring = _LocalRing(index, chunks)
    dq, *home_grads = _ring_backward(ring, causal, use_flash, q, *home, out,
                                     lse, do)
    stored = ring.stored("grads")
    stored[index] = home_grads
    dk = [s[0].to(k.dtype) for s, k in zip(stored, k_chunks)]
    dv = [s[1].to(v.dtype) for s, v in zip(stored, v_chunks)]
    dbias = None
    if bias_chunks is not None:
        dbias = [s[2].to(b.dtype) for s, b in zip(stored, biases)]
    return out, dq, dk, dv, dbias


# -- Ulysses ------------------------------------------------------------------


def _all_to_all(x, group, n: int, split_dim: int, concat_dim: int):
    """Tiled all-to-all: part ``j`` of ``split_dim`` goes to rank ``j``;
    the parts received are concatenated along ``concat_dim`` in rank
    order. ``all_to_all_single`` splits dimension 0, so ``split_dim`` is
    moved to the front (contiguous) and put back afterwards."""
    x = x.movedim(split_dim, 0)
    parts = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    return out.reshape(shape[:concat_dim]
                       + [shape[concat_dim] * shape[concat_dim + 1]]
                       + shape[concat_dim + 2:])


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad.contiguous(), *ctx.args),
                None, None, None, None)


class _AllGatherKeys(torch.autograd.Function):
    """The key-side bias chunks of every rank, concatenated along the key
    dimension (3); the backward sums the cotangents over the ranks and
    keeps this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.args = (group, index, x.shape[3])
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=3)

    @staticmethod
    def backward(ctx, grad):
        group, index, sk = ctx.args
        grad = grad.contiguous()
        dist.all_reduce(grad, group=group)
        return grad.narrow(3, index * sk, sk), None, None, None


def _full_attention(q, k, v, bias):
    """Plain full-sequence attention (f32 softmax), used per Ulysses shard
    and as the reference in tests."""
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.matmul(qf, k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def _ulysses_shard(q, k, v, kv_bias, group, n: int, index: int, causal: bool,
                   use_flash: bool):
    """Sequence-split -> head-split -> attention -> back."""
    if n > 1:
        q, k, v = (_AllToAll.apply(t, group, n, 1, 2) for t in (q, k, v))
        if kv_bias is not None:
            # No head dimension to scatter: gather the whole bias instead.
            kv_bias = _AllGatherKeys.apply(kv_bias, group, n, index)
    if use_flash:
        out = fa.flash_attention(q, k, v, kv_bias)
    else:
        bias = kv_bias
        if causal:
            pos = torch.arange(q.shape[2], device=q.device)
            cb = causal_bias(pos, pos)
            bias = cb if bias is None else bias + cb
        out = _full_attention(q, k, v, bias)
    if n > 1:
        out = _AllToAll.apply(out, group, n, 2, 1)
    return out


# -- public API (JAX package names) -------------------------------------------


def _resolve_flash(q: torch.Tensor, causal: bool,
                   use_flash: Optional[bool]) -> bool:
    if use_flash is None:
        use_flash = not causal and q.device.type == "cuda"
    if use_flash and causal:
        raise ValueError(
            "use_flash=True does not support causal=True (the key-side bias "
            "cannot express the causal mask); use the einsum path")
    return use_flash


def _check_axes(mesh, seq_axis: str, batch_axis: Optional[str]) -> None:
    for axis in (seq_axis, batch_axis):
        if axis is not None and axis not in mesh.mesh_dim_names:
            raise ValueError(f"axis {axis!r} is not in the mesh's axes "
                             f"{mesh.mesh_dim_names}")


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, seq_axis: str,
                        bias: Optional[torch.Tensor] = None,
                        batch_axis: Optional[str] = None,
                        causal: bool = False,
                        use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact attention over a sequence split on ``mesh``'s ``seq_axis``.

    Args:
        q, k, v: this rank's chunk ``(B_local, H, S/n, D)``; every rank's
            chunk has the same length.
        bias: this rank's chunk of an additive key-side bias
            ``(B_local, 1, 1, S/n)`` (e.g. padding as 0 / ``NEG_INF``).
        batch_axis: the axis the batch is split over; each rank already
            holds its block, so it only has to name an axis of the mesh.
        causal: a causal mask over global positions.
        use_flash: each hop through ``ops.flash_attention``. ``None``: on
            for non-causal attention on CUDA tensors, off otherwise;
            ``True`` on CPU tensors runs the flash kernels' plain versions.

    Returns this rank's output chunk, like ``q``; differentiable in q, k,
    v and bias.
    """
    use_flash = _resolve_flash(q, causal, use_flash)
    _check_axes(mesh, seq_axis, batch_axis)
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _RingAttention.apply(_ProcessRing(mesh, seq_axis), causal,
                                use_flash, q, k, v, bias)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, seq_axis: str,
                      bias: Optional[torch.Tensor] = None,
                      batch_axis: Optional[str] = None,
                      causal: bool = False,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses all-to-all sequence parallelism, with the contract
    of :func:`ring_self_attention`; the head count must be divisible by
    the ``seq_axis`` size."""
    n = pmesh.axis_size(mesh, seq_axis)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention needs num_heads ({q.shape[1]}) divisible by "
            f"mesh axis {seq_axis!r} size ({n})")
    use_flash = _resolve_flash(q, causal, use_flash)
    _check_axes(mesh, seq_axis, batch_axis)
    return _ulysses_shard(q, k, v, bias, mesh.get_group(seq_axis), n,
                          pmesh.axis_index(mesh, seq_axis), causal,
                          use_flash)


def make_attention_fn(mesh, seq_axis: str, strategy: str = "ring",
                      batch_axis: Optional[str] = None, causal: bool = False,
                      use_flash: Optional[bool] = None):
    """An ``attention_fn(q, k, v, bias) -> out`` for ``models/bert.py``,
    bound to a mesh and a strategy (``"ring"`` or ``"ulysses"``)."""
    if strategy == "ring":
        impl = ring_self_attention
    elif strategy == "ulysses":
        impl = ulysses_attention
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    def attention_fn(q, k, v, bias=None):
        return impl(q, k, v, mesh, seq_axis, bias=bias,
                    batch_axis=batch_axis, causal=causal,
                    use_flash=use_flash)

    return attention_fn
