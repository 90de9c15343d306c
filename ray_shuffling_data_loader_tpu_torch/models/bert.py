"""BERT-style masked LM (counterpart of the JAX package's ``models/bert.py``).

Token ids ``(B, S)`` -> logits ``(B, S, vocab)``. Parameters are float32,
compute is ``compute_dtype``, the softmax and the logits float32. Weights
are stored ``(d_in, d_out)`` and applied as ``x @ w + b``, the JAX
package's layout, so its parameters load without a transpose
(``weights.bert_from_jax_params``). Where PyTorch's defaults differ, this
module follows the JAX package: tanh-approximated GELU (``jax.nn.gelu``'s
default), LayerNorm with eps 1e-12 and the population variance in f32,
clamped token ids (``jnp.take(mode="clip")``), and an inline attention
whose score product runs in the compute dtype before the cast to f32.

``attention_fn(q, k, v, bias) -> (B, H, S, D)`` swaps the attention, e.g.
``ops.flash_attention.make_flash_attention_fn()`` for the flash kernels;
the bias is the key-side ``(B, 1, 1, S)`` f32 mask (0 or -1e9) or None.

Sequence parallelism (``ops.ring_attention.make_attention_fn``): each rank
passes its chunk of the tokens and the chunk's global ``position_offset``;
:func:`loss_fn` with a ``mesh`` returns the rank's term of the global loss.

Tensor parallelism (:func:`param_specs`, ``parallel.tp``): the token and
position embeddings are split on the hidden dim, so each rank looks up
``(..., H/tp)`` blocks, gathered before the replicated LayerNorm. The
fused QKV projection is split by head (``BertLayer.tp_fused``: rank r
holds heads ``[r nh/tp, (r+1) nh/tp)`` of each of q, k and v), so
``attention_fn`` sees ``nh/tp`` heads; ``attn_out`` and ``ffn_out`` are
row-parallel, ``ffn_in`` column-parallel. The MLM head, tied to the
hidden-split token embedding, gathers the table in the compute dtype
(``V * H`` values) and computes the whole logits on every rank; partial
logits with an all-reduce would move a ``(B, S, V)`` f32 tensor instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel import tp as tpar
from ray_shuffling_data_loader_tpu_torch.utils.config import resolve_device

IGNORE_ID = -100

AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    compute_dtype: torch.dtype = torch.bfloat16
    # Recompute each layer in the backward pass instead of saving its
    # activations (torch.utils.checkpoint, non-reentrant).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


def bert_base() -> BertConfig:
    return BertConfig()


def bert_tiny() -> BertConfig:
    """For tests and CPU smoke runs."""
    return BertConfig(vocab_size=1000, hidden_dim=64, num_layers=2,
                      num_heads=4, ffn_dim=128, max_seq_len=64)


def param_specs(config: BertConfig, model_axis: str = "model"
                ) -> Dict[str, Tuple]:
    """The JAX package's Megatron layout: embeddings split on the hidden
    dim; per layer QKV and ``ffn_in`` column-parallel (weights and
    biases), ``attn_out`` and ``ffn_out`` row-parallel; LayerNorms and the
    other biases replicated."""
    col, row, rep = (None, model_axis), (model_axis, None), (None,)
    specs: Dict[str, Tuple] = {
        "token_emb": col, "pos_emb": col, "emb_ln.scale": rep,
        "emb_ln.bias": rep, "mlm_bias": rep}
    layer = {"qkv_w": col, "qkv_b": (model_axis,), "attn_out_w": row,
             "attn_out_b": rep, "ln1.scale": rep, "ln1.bias": rep,
             "ffn_in_w": col, "ffn_in_b": (model_axis,), "ffn_out_w": row,
             "ffn_out_b": rep, "ln2.scale": rep, "ln2.bias": rep}
    for i in range(config.num_layers):
        specs.update({f"layer_{i}.{k}": v for k, v in layer.items()})
    return specs


# The layout the tensor-parallel forward is written for (sharded dims).
_LAYER_LAYOUT = {"qkv_w": 1, "qkv_b": 0, "attn_out_w": 0, "attn_out_b": None,
                 "ffn_in_w": 1, "ffn_in_b": 0, "ffn_out_w": 0,
                 "ffn_out_b": None}


class LayerNormParams(nn.Module):
    """``scale`` (ones) and ``bias`` (zeros), f32."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))


def _layer_norm(x: torch.Tensor, params: LayerNormParams,
                eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps) * params.scale + params.bias
    return out.to(x.dtype)


def _normal(shape, generator, device, scale: float = 0.02) -> nn.Parameter:
    return nn.Parameter(
        torch.randn(shape, generator=generator, device=device) * scale)


class BertLayer(nn.Module):
    """One post-LN transformer layer with a fused QKV projection."""

    tp: Optional[tpar.ModelParallel] = None
    # q|k|v side by side: tensor parallelism splits each of the three.
    tp_fused = {"qkv_w": 3, "qkv_b": 3}

    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        h, f = config.hidden_dim, config.ffn_dim
        self.config = config
        self.qkv_w = _normal((h, 3 * h), generator, device)
        self.qkv_b = nn.Parameter(torch.zeros(3 * h, device=device))
        self.attn_out_w = _normal((h, h), generator, device)
        self.attn_out_b = nn.Parameter(torch.zeros(h, device=device))
        self.ln1 = LayerNormParams(h, device)
        self.ffn_in_w = _normal((h, f), generator, device)
        self.ffn_in_b = nn.Parameter(torch.zeros(f, device=device))
        self.ffn_out_w = _normal((f, h), generator, device)
        self.ffn_out_b = nn.Parameter(torch.zeros(h, device=device))
        self.ln2 = LayerNormParams(h, device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                attention_fn: Optional[AttentionFn] = None) -> torch.Tensor:
        config = self.config
        dtype = config.compute_dtype
        b, s, h = x.shape
        nh, hd = config.num_heads, config.head_dim
        mp = self.tp
        if mp is not None:
            mp.require(_LAYER_LAYOUT)
            nh //= mp.size
        qkv = (tpar.copy_to_model(x, mp) @ self.qkv_w.to(dtype)
               + self.qkv_b.to(dtype))
        q, k, v = (t.reshape(b, s, nh, hd).transpose(1, 2)
                   for t in qkv.split(nh * hd, dim=-1))
        if attention_fn is not None:
            attended = attention_fn(q, k, v, bias)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
            scores = scores / (hd ** 0.5)
            if bias is not None:
                scores = scores + bias
            weights = torch.softmax(scores, dim=-1).to(dtype)
            attended = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        attended = attended.transpose(1, 2).reshape(b, s, nh * hd)
        attn_out = (tpar.reduce_from_model(
            attended @ self.attn_out_w.to(dtype), mp)
            + self.attn_out_b.to(dtype))
        x = _layer_norm(x + attn_out, self.ln1)
        ffn = F.gelu(tpar.copy_to_model(x, mp) @ self.ffn_in_w.to(dtype)
                     + self.ffn_in_b.to(dtype), approximate="tanh")
        ffn = (tpar.reduce_from_model(ffn @ self.ffn_out_w.to(dtype), mp)
               + self.ffn_out_b.to(dtype))
        return _layer_norm(x + ffn, self.ln2)


class Bert(nn.Module):
    """Parameters as the JAX package's pytree: ``token_emb``, ``pos_emb``,
    ``emb_ln.{scale,bias}``, ``layer_{i}.*`` and ``mlm_bias``; weights
    ~ 0.02 N(0, 1) from ``generator``, biases zero, LayerNorm scales one.
    ``device=None`` means CUDA and raises without it."""

    tp: Optional[tpar.ModelParallel] = None

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        h = config.hidden_dim
        self.config = config
        self.token_emb = _normal((config.vocab_size, h), generator, device)
        self.pos_emb = _normal((config.max_seq_len, h), generator, device)
        self.emb_ln = LayerNormParams(h, device)
        for i in range(config.num_layers):
            setattr(self, f"layer_{i}", BertLayer(config, device, generator))
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                 device=device))

    def forward(self, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                attention_fn: Optional[AttentionFn] = None,
                position_offset: int = 0) -> torch.Tensor:
        """``attention_mask`` ``(B, S)``: 1 attends, 0 is padding; None
        attends everywhere. ``position_offset``: the global position of
        ``token_ids[:, 0]`` (a sequence chunk's offset). Returns f32 logits
        ``(B, S, vocab)``."""
        config = self.config
        dtype = config.compute_dtype
        s = token_ids.shape[1]
        if position_offset + s > config.max_seq_len:
            raise ValueError(
                f"positions {position_offset}..{position_offset + s - 1} "
                f"exceed max_seq_len {config.max_seq_len}")
        mp = self.tp
        ids = token_ids.long().clamp(0, config.vocab_size - 1)
        positions = self.pos_emb[position_offset:position_offset + s]
        x = (F.embedding(ids, self.token_emb) + positions[None]).to(dtype)
        if mp is not None:
            mp.require({"token_emb": 1, "pos_emb": 1})
        x = _layer_norm(tpar.gather_from_model(x, mp, -1), self.emb_ln)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               -1e9).to(torch.float32)
        for i in range(config.num_layers):
            layer = getattr(self, f"layer_{i}")
            if config.remat:
                x = checkpoint.checkpoint(layer, x, bias, attention_fn,
                                          use_reentrant=False)
            else:
                x = layer(x, bias, attention_fn)
        # MLM head, tied to the token embedding.
        logits = x @ tpar.gather_from_model(self.token_emb.to(dtype), mp,
                                            1).t()
        return logits.float() + self.mlm_bias


def apply(model: Bert, token_ids: torch.Tensor,
          attention_mask: Optional[torch.Tensor] = None,
          attention_fn: Optional[AttentionFn] = None,
          position_offset: int = 0) -> torch.Tensor:
    """Logits ``(B, S, vocab)`` f32 (the JAX package's ``apply``)."""
    return model(token_ids, attention_mask, attention_fn, position_offset)


def loss_fn(model: Bert, token_ids: torch.Tensor, mlm_targets: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None,
            attention_fn: Optional[AttentionFn] = None,
            position_offset: int = 0, mesh=None) -> torch.Tensor:
    """Masked-LM cross-entropy, the mean over positions whose target is not
    ``IGNORE_ID`` (the count clamped to at least 1).

    With ``mesh`` (which spans every rank, as ``parallel.mesh`` builds
    it), the inputs are this rank's block of the global batch and the
    count is summed over the ranks that hold other data
    (``parallel.mesh.batch_group``: every rank but the model peers): the
    value is this rank's term of the global mean, so the terms, and their
    gradients, sum over those ranks to the global loss and its
    gradient."""
    logits = model(token_ids, attention_mask, attention_fn, position_offset)
    targets = mlm_targets.long()
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1), ignore_index=IGNORE_ID,
                            reduction="sum")
    count = (targets != IGNORE_ID).sum()
    if mesh is not None:
        dist.all_reduce(count, group=pmesh.batch_group(mesh))
    return total / count.clamp(min=1)
