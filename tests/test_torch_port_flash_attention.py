"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs (seeded) go to the JAX package's ``flash_forward``,
``flash_backward`` and ``flash_attention`` (Pallas in interpret mode, as
``tests/test_flash_attention.py`` runs them on the CPU) and to the port's
counterparts, which take their plain PyTorch versions for CPU tensors.
Tolerances are those of the JAX package's own tests: 1e-5 for the f32
forward, 1e-4 for gradients, 2e-2 for bf16 inputs.

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one (run them there with
``python -m pytest -m cuda tests/test_torch_port_flash_attention.py``).
The kernels round P and dS to bf16 for the tensor cores, so they are held
to 2e-2, the bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.ops import flash_attention as jfa
from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 4, 64, 16


def _arrays(seed, s=S, sk=None, d=D, bias=False):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((B, H, s, d)).astype(np.float32)
    k = rng.standard_normal((B, H, sk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, sk, d)).astype(np.float32)
    b = None
    if bias:
        mask = rng.integers(0, 2, (B, sk))
        mask[:, 0] = 1  # every query row keeps a real key
        b = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(
            np.float32) + 0.1 * rng.standard_normal((B, 1, 1, sk)).astype(
                np.float32)
    return q, k, v, b


def _jax(*arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


def _torch(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(np.array(a)).to(dtype)
            for a in arrays]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("s,with_bias", [(64, False), (64, True),
                                         (45, False), (45, True)])
def test_forward_matches_pallas_f32(s, with_bias):
    q, k, v, b = _arrays(1, s=s, bias=with_bias)
    want_out, want_lse = jfa.flash_forward(*_jax(q, k, v, b), block_q=16,
                                           block_k=16, interpret=True)
    out, lse = tfa.flash_forward(*_torch(q, k, v, b))
    assert out.dtype == torch.float32 and tuple(lse.shape) == (B, H, s, 1)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)


def test_forward_bf16_inputs():
    q, k, v, b = _arrays(2, bias=True)
    want_out, want_lse = jfa.flash_forward(
        *_jax(q, k, v, dtype=jnp.bfloat16), jnp.asarray(b), block_q=16,
        block_k=16, interpret=True)
    out, lse = tfa.flash_forward(*_torch(q, k, v, dtype=torch.bfloat16),
                                 torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(want_out, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse), rtol=2e-2,
                               atol=2e-2)


def _backward_inputs(seed, s=S, sk=None, with_bias=True):
    q, k, v, b = _arrays(seed, s=s, sk=sk, bias=with_bias)
    do = np.random.default_rng(seed + 100).standard_normal(q.shape).astype(
        np.float32)
    out, lse = jfa.flash_forward(*_jax(q, k, v, b), block_q=16, block_k=16,
                                 interpret=True)
    return q, k, v, b, np.asarray(out), np.asarray(lse), do


@pytest.mark.parametrize("s,with_bias,lse_rank", [(64, True, 4),
                                                  (64, False, 3),
                                                  (45, True, 3)])
def test_backward_matches_pallas(s, with_bias, lse_rank):
    q, k, v, b, out, lse, do = _backward_inputs(3, s=s, with_bias=with_bias)
    want = jfa.flash_backward(*_jax(q, k, v, b, out, lse, do), block_q=16,
                              block_k=16, interpret=True)
    if lse_rank == 3:
        lse = lse[..., 0]
    got = tfa.flash_backward(*_torch(q, k, v, b, out, lse, do))
    assert len(got) == 4
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_backward_with_global_lse_over_more_keys():
    # The lse of attention over 2S keys, the backward over the first S of
    # them: the per-hop gradients ring attention sums.
    q, k, v, b = _arrays(4, sk=2 * S, bias=True)
    _, lse = jfa.flash_forward(*_jax(q, k, v, b), block_q=16, block_k=16,
                               interpret=True)
    lse = np.asarray(lse)
    k1, v1, b1 = k[:, :, :S], v[:, :, :S], np.ascontiguousarray(
        b[..., :S])
    do = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    out1 = np.asarray(jfa.flash_forward(*_jax(q, k1, v1, b1), block_q=16,
                                        block_k=16, interpret=True)[0])
    want = jfa.flash_backward(*_jax(q, k1, v1, b1, out1, lse, do),
                              block_q=16, block_k=16, interpret=True)
    got = tfa.flash_backward(*_torch(q, k1, v1, b1, out1, lse, do))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_bias", [False, True])
def test_autograd_matches_jax_grad(with_bias):
    q, k, v, b = _arrays(6, bias=with_bias)

    def jloss(q, k, v, b):
        return jnp.sum(jfa.flash_attention(q, k, v, b, 16, 16, True) ** 2)

    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(*_jax(q, k, v, b))
    tq, tk, tv, tb = _torch(q, k, v, b)
    leaves = [t for t in (tq, tk, tv, tb) if t is not None]
    for t in leaves:
        t.requires_grad_(True)
    (tfa.flash_attention(tq, tk, tv, tb) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_mask_bias_without_grad():
    # BERT's mask bias needs no gradient: only q, k, v get one.
    q, k, v, b = _torch(*_arrays(7, bias=True))
    for t in (q, k, v):
        t.requires_grad_(True)
    tfa.flash_attention(q, k, v, b).sum().backward()
    assert all(t.grad is not None for t in (q, k, v)) and b.grad is None


@pytest.mark.parametrize("shape", [(B, 1, S, S), (B, H, 1, S), (B, S),
                                   (1, 1, 1, S)])
def test_non_key_side_bias_raises(shape):
    q, k, v, _ = _torch(*_arrays(8))
    with pytest.raises(ValueError, match="key-side"):
        tfa.flash_attention(q, k, v, torch.zeros(shape))
    with pytest.raises(ValueError, match="key-side"):
        tfa.flash_forward(q, k, v, torch.zeros(shape))


def test_kernel_wrappers_refuse_what_they_do_not_take():
    q, k, v, _ = _torch(*_arrays(9), dtype=torch.bfloat16)
    lse = torch.zeros((B, H, S))
    # A CPU tensor never reaches the plain version through a kernel wrapper.
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_dq(q, k, v, None, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_dkv(q, k, v, None, q, lse, lse)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_fwd(q.float(), k.float(), v.float())
    wide = torch.zeros((B, H, S, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_fwd(wide, wide, wide)


def test_cpu_path_launches_no_kernel():
    tfa.reset_launch_counts()
    q, k, v, b = _torch(*_arrays(10, bias=True))
    q.requires_grad_(True)
    tfa.flash_attention(q, k, v, b).sum().backward()
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0}


def test_auto_attention_fn_keeps_the_jax_rule():
    assert tfa.FLASH_MIN_SEQ_LEN == jfa.FLASH_MIN_SEQ_LEN
    assert tfa.auto_attention_fn(4096, device="cpu") is None
    fn = tfa.make_flash_attention_fn()
    q, k, v, _ = _torch(*_arrays(11))
    torch.testing.assert_close(fn(q, k, v), tfa.flash_forward(q, k, v)[0])


# -- on the card: each kernel against its plain version -----------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_inputs(b, h, sq, sk, d, with_bias, seed=0):
    """bf16 q, k, v, dO and a key-side bias: None (``with_bias`` false),
    masking about 20 % of the keys (true) or, for ``"one_key"``, every key
    but one."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)

    q, k, v, do = randn(b, h, sq, d), randn(b, h, sk, d), randn(
        b, h, sk, d), randn(b, h, sq, d)
    bias = None
    if with_bias == "one_key":
        keep = torch.zeros((b, 1, 1, sk), dtype=torch.bool, device="cuda")
        keep[..., sk // 2] = True
        bias = torch.where(keep, 0.0, -1e9).to(torch.float32)
    elif with_bias:
        keep = torch.rand((b, 1, 1, sk), device="cuda", generator=g) < 0.8
        keep[..., 0] = True
        bias = torch.where(keep, 0.0, -1e9).to(torch.float32)
    return q, k, v, do, bias


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# (B, H, Sq, Sk, bias): tiles that are full, ragged on either side, shorter
# than one tile (Sk < 64, Sq = 1), Sq != Sk; one query row against four
# key tiles with a ragged last one; more blocks than one wave of the card
# (B=16, H=12, S=512); a bias that masks every key but one.
_CARD_CASES = [(2, 3, 128, 128, False), (2, 3, 100, 77, True),
               (2, 3, 64, 200, True), (2, 3, 1, 64, False),
               (2, 3, 1, 200, True), (2, 3, 64, 1, True),
               (2, 3, 65, 63, True), (2, 3, 128, 65, False),
               (2, 3, 300, 500, True), (16, 12, 512, 512, False),
               (2, 3, 96, 160, "one_key")]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,h,sq,sk,with_bias", _CARD_CASES)
def test_cuda_kernels_match_plain(d, b, h, sq, sk, with_bias):
    _cuda_or_skip()
    q, k, v, do, bias = _card_inputs(b, h, sq, sk, d, with_bias)
    out, lse = tfa.flash_fwd(q, k, v, bias)
    want_out, want_lse = tfa.flash_forward_reference(q, k, v, bias)
    _close(out, want_out)
    _close(lse, want_lse)
    delta = (do.float() * out.float()).sum(-1)
    _close(tfa.flash_dq(q, k, v, bias, do, lse, delta),
           tfa.flash_dq_reference(q, k, v, bias, do, lse, delta))
    got = tfa.flash_dkv(q, k, v, bias, do, lse, delta)
    want = tfa.flash_dkv_reference(q, k, v, bias, do, lse, delta)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _close(g, w)


@pytest.mark.cuda
def test_cuda_dkv_with_global_lse():
    _cuda_or_skip()
    q, k, v, do, bias = _card_inputs(2, 2, 96, 160, 64, True, seed=1)
    _, lse = tfa.flash_forward_reference(q, k, v, bias)
    k1, v1 = k[:, :, :80].contiguous(), v[:, :, :80].contiguous()
    b1 = bias[..., :80].contiguous()
    out1, _ = tfa.flash_fwd(q, k1, v1, b1)
    delta = (do.float() * out1.float()).sum(-1)
    got = tfa.flash_dkv(q, k1, v1, b1, do, lse, delta)
    want = tfa.flash_dkv_reference(q, k1, v1, b1, do, lse, delta)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tfa.flash_dq(q, k1, v1, b1, do, lse, delta),
           tfa.flash_dq_reference(q, k1, v1, b1, do, lse, delta))


@pytest.mark.cuda
def test_cuda_autograd_launches_each_kernel_once():
    _cuda_or_skip()
    q, k, v, do, bias = _card_inputs(2, 2, 64, 64, 32, True, seed=2)
    leaves = [t.requires_grad_(True) for t in (q, k, v, bias)]
    tfa.reset_launch_counts()
    tfa.flash_attention(*leaves).backward(do)
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_dq": 1,
                                 "flash_dkv": 1}
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    out, _ = tfa.flash_forward_reference(*ref)
    out.float().backward(do.float())
    for t, r in zip(leaves, ref):
        _close(t.grad, r.grad)
