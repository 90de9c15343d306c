"""The port's DLRM against the JAX package's, on the same parameters.

A small config (4 tables, one above ``ONE_HOT_MAX_VOCAB`` so it takes the
gather path, embed 8) is initialised by the JAX package and loaded into the
port through ``weights.from_jax_params``. In f32, logits, loss and every
gradient agree within 1e-5 relative: elementwise ``rtol=1e-5`` with
``atol`` 1e-5 times the tensor's largest magnitude, since the two
frameworks sum matmuls in different orders and entries near zero have no
meaningful relative error. In bf16 the frameworks round at different
points (matmul outputs, bias adds), so the bound there is 2e-2 of the
tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.models import dlrm as jdlrm
from ray_shuffling_data_loader_tpu_torch import weights
from ray_shuffling_data_loader_tpu_torch.models import dlrm as tdlrm

VOCABS = (3000, 50, 7, 300)
BATCH = 64


def _configs(compute, lookup=("auto", "auto"), dense_dim=0):
    jdt, tdt = compute
    jcfg = jdlrm.DLRMConfig(vocab_sizes=VOCABS, embed_dim=8,
                            dense_dim=dense_dim, bottom_hidden=(8,),
                            top_hidden=(16, 8), compute_dtype=jdt,
                            lookup_mode=lookup[0])
    tcfg = tdlrm.DLRMConfig(vocab_sizes=VOCABS, embed_dim=8,
                            dense_dim=dense_dim, bottom_hidden=(8,),
                            top_hidden=(16, 8), compute_dtype=tdt,
                            lookup_mode=lookup[1])
    return jcfg, tcfg


def _setup(jcfg, tcfg, seed=0):
    params = jdlrm.init(jcfg, jax.random.key(seed))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = tdlrm.DLRM(tcfg, device="cpu")
    model.load_state_dict(weights.from_jax_params(tcfg, params_np))
    return params, model


def _batch(rng, dense_dim=0):
    sparse = np.stack([rng.integers(-3, v + 3, BATCH) for v in VOCABS],
                      axis=1).astype(np.int32)
    labels = rng.random((BATCH, 1)).astype(np.float32)
    dense = (rng.standard_normal((BATCH, dense_dim)).astype(np.float32)
             if dense_dim else None)
    return sparse, labels, dense


def _close(got, want, rel):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_grads(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _compare(jcfg, tcfg, rng, rel, dense_dim=0):
    params, model = _setup(jcfg, tcfg)
    sparse, labels, dense = _batch(rng, dense_dim)
    jdense = None if dense is None else jnp.asarray(dense)
    tdense = None if dense is None else torch.from_numpy(dense)
    want_logits = jdlrm.apply(jcfg, params, jdense, jnp.asarray(sparse))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jdlrm.loss_fn(jcfg, p, jdense, jnp.asarray(sparse),
                                jnp.asarray(labels)))(params)
    logits = model(tdense, torch.from_numpy(sparse))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 1)
    loss = tdlrm.loss_fn(model, tdense, torch.from_numpy(sparse),
                         torch.from_numpy(labels))
    loss.backward()
    _close(logits.detach().numpy(), want_logits, rel)
    _close(loss.item(), want_loss, rel)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = _flat_grads(want_grads)
    assert grads.keys() == want.keys()
    for name in want:
        _close(grads[name], want[name], rel)


@pytest.mark.parametrize("lookup", [("auto", "auto"), ("pallas", "kernel"),
                                    ("take", "take"),
                                    ("one_hot", "one_hot")])
def test_f32_logits_loss_grads_match_jax(rng, lookup):
    jcfg, tcfg = _configs((jnp.float32, torch.float32), lookup)
    _compare(jcfg, tcfg, rng, rel=1e-5)


def test_f32_with_dense_branch_matches_jax(rng):
    jcfg, tcfg = _configs((jnp.float32, torch.float32), dense_dim=5)
    _compare(jcfg, tcfg, rng, rel=1e-5, dense_dim=5)


@pytest.mark.parametrize("lookup", [("auto", "auto"), ("pallas", "kernel")])
def test_bf16_within_stated_bound(rng, lookup):
    jcfg, tcfg = _configs((jnp.bfloat16, torch.bfloat16), lookup)
    _compare(jcfg, tcfg, rng, rel=2e-2)


def test_column_layout_equals_array_layout(rng):
    _, tcfg = _configs((jnp.float32, torch.float32))
    model = tdlrm.DLRM(tcfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    sparse, _, _ = _batch(rng)
    stacked = model(None, torch.from_numpy(sparse))
    narrow = [torch.int16, torch.int8, torch.int8, torch.int16]
    cols = [torch.from_numpy(sparse[:, i:i + 1]).to(dt)
            for i, dt in enumerate(narrow)]
    torch.testing.assert_close(model(None, cols), stacked, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sparse columns"):
        model(None, cols[:2])


def test_column_layout_matches_jax_column_layout(rng):
    jcfg, tcfg = _configs((jnp.float32, torch.float32))
    params, model = _setup(jcfg, tcfg)
    sparse, _, _ = _batch(rng)
    jcols = [jnp.asarray(sparse[:, i:i + 1]) for i in range(len(VOCABS))]
    tcols = [torch.from_numpy(sparse[:, i:i + 1]) for i in range(len(VOCABS))]
    _close(model(None, tcols).detach().numpy(),
           jdlrm.apply(jcfg, params, None, jcols), 1e-5)


def test_validate_sparse_batch_both_layouts(rng):
    _, tcfg = _configs((jnp.float32, torch.float32))
    ok = np.stack([rng.integers(0, v, 6) for v in VOCABS], axis=1)
    tdlrm.validate_sparse_batch(tcfg, ok)
    cols = [torch.from_numpy(ok[:, i:i + 1]) for i in range(len(VOCABS))]
    tdlrm.validate_sparse_batch(tcfg, cols)
    bad = list(cols)
    bad[2] = bad[2] + 7
    with pytest.raises(ValueError, match="outside vocab"):
        tdlrm.validate_sparse_batch(tcfg, bad)
    with pytest.raises(ValueError, match="columns"):
        tdlrm.validate_sparse_batch(tcfg, cols[:1])


def test_from_jax_params_rejects_mismatch():
    jcfg, tcfg = _configs((jnp.float32, torch.float32))
    params_np = jax.tree_util.tree_map(
        np.asarray, jdlrm.init(jcfg, jax.random.key(0)))
    params_np["top"]["w0"] = params_np["top"]["w0"].T
    with pytest.raises(ValueError, match="top.w0"):
        weights.from_jax_params(tcfg, params_np)
    del params_np["top"]["w0"]
    with pytest.raises(ValueError, match="missing"):
        weights.from_jax_params(tcfg, params_np)


def test_device_none_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None is valid here")
    _, tcfg = _configs((jnp.float32, torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdlrm.DLRM(tcfg)


def test_mlperf_config_widths():
    cfg = tdlrm.MLPERF
    assert cfg.embed_dim == 128 and cfg.top_hidden == (1024, 1024, 512, 256)
    assert cfg.vocab_sizes == jdlrm.DATA_SPEC_VOCAB_SIZES
    assert sum(cfg.vocab_sizes) == 2_912_607
    assert sum(v > 2048 for v in cfg.vocab_sizes) == 8
    assert cfg.top_in_dim == jdlrm.DLRMConfig(
        embed_dim=128, top_hidden=(1024, 1024, 512, 256)).top_in_dim
