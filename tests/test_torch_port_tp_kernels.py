"""The gather and flash kernels at the shapes tensor parallelism gives them
at two ranks on the model axis (``parallel/tp.py``), against their plain
versions. They need the card and skip where there is none (run them there
with ``python -m pytest -m cuda tests/test_torch_port_tp_kernels.py``).

- Gather: DLRM ``mlperf``'s 8 tables above 2,048 rows, each cut to the
  ``(V, 64)`` column block of rank 0 and of rank 1
  (``tp.shard_tensor``), B=2048 int32 ids (some out of range), bf16
  rows, in one grouped launch: bit for bit.
- Flash: BERT-base's attention on 6 of its 12 heads, B=4, S=512, D=64,
  bf16, with and without a masking bias: within 2e-2 absolute plus 2e-2
  relative (the kernels round P and dS to bf16).
"""

import pytest
import torch

from ray_shuffling_data_loader_tpu_torch.models import dlrm
from ray_shuffling_data_loader_tpu_torch.ops import embedding as temb
from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as tfa
from ray_shuffling_data_loader_tpu_torch.parallel import tp

MODEL_PARALLEL, MICROBATCH = 2, 2048


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("rank", range(MODEL_PARALLEL))
def test_cuda_gather_on_column_blocks_bit_exact(rank):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(rank)
    vocabs = [v for v in dlrm.MLPERF.vocab_sizes
              if v > temb.ONE_HOT_MAX_VOCAB]
    assert len(vocabs) == 8
    tables = [tp.shard_tensor(
        torch.randn((v, dlrm.MLPERF.embed_dim), device="cuda", generator=g),
        1, 1, MODEL_PARALLEL, rank) for v in vocabs]
    assert all(t.shape[1] == 64 and t.is_contiguous() for t in tables)
    indices = [torch.randint(-100, v + 100, (MICROBATCH,), device="cuda",
                             dtype=torch.int32, generator=g)
               for v in vocabs]
    temb.reset_launch_counts()
    vectors = temb.lookup_features(tables, indices, torch.bfloat16,
                                   mode="kernel")
    assert temb.launch_counts["gather_rows"] == 1
    want = temb.gather_grouped_reference(tables, indices, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(vectors), want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_flash_on_half_the_heads(with_bias):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(int(with_bias))
    shape = (4, 12 // MODEL_PARALLEL, 512, 64)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    bias = None
    if with_bias:
        keep = torch.rand((4, 1, 1, 512), device="cuda", generator=g) < 0.8
        keep[..., 0] = True
        bias = torch.where(keep, 0.0, -1e9).to(torch.float32)

    def close(got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)

    out, lse = tfa.flash_fwd(q, k, v, bias)
    want_out, want_lse = tfa.flash_forward_reference(q, k, v, bias)
    close(out, want_out)
    close(lse, want_lse)
    delta = (do.float() * out.float()).sum(-1)
    close(tfa.flash_dq(q, k, v, bias, do, lse, delta),
          tfa.flash_dq_reference(q, k, v, bias, do, lse, delta))
    got = tfa.flash_dkv(q, k, v, bias, do, lse, delta)
    want = tfa.flash_dkv_reference(q, k, v, bias, do, lse, delta)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            close(a, b)
