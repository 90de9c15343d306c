"""The port's ring attention and Ulysses against the JAX package's.

The matrix of ``tests/test_ring_attention.py`` at its sizes (B=2, H=8,
S=64, D=16, f32). The inputs are made once with numpy from a seed. The
JAX side runs on ``Mesh(jax.devices()[:n], ("seq",))`` of the conftest's
8-device CPU platform (flash in interpret mode); the port side runs in
spawned gloo worlds of n = 2 and n = 4 (``torch_port_world``), each world
once for the whole file, and each rank returns its sequence chunk of the
outputs and gradients, which are put back together here.

Tolerances are the JAX tests' own: 1e-5 for outputs, 1e-4 for gradients
(of ``sum(out ** 2)``), 2e-4 for BERT logits, 1e-4 relative for the BERT
loss and rtol 5e-3 / atol 5e-4 for its gradients (each rank holds its
term of the loss; the terms and their gradients are summed over the
ranks here).

The one-process ring walk that ``chip_smoke.py`` runs on the card
(``ring_walk``) is held here against whole-sequence attention on the CPU;
the card-only test repeats it through the flash kernels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_port_world as world
from ray_shuffling_data_loader_tpu.models import bert as jbert
from ray_shuffling_data_loader_tpu.ops import ring_attention as jra
from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as tfa
from ray_shuffling_data_loader_tpu_torch.ops import ring_attention as tra

B, H, S, D = 2, 8, 64, 16
WORLD_SIZES = (2, 4)
FWD_TOL, GRAD_TOL, APPLY_TOL = 1e-5, 1e-4, 2e-4
LOSS_RTOL, BERT_GRAD_RTOL, BERT_GRAD_ATOL = 1e-4, 5e-3, 5e-4
JOIN_TIMEOUT_S = 240
APPLY_CONFIG = dict(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=8,
                    ffn_dim=64, max_seq_len=S)
LOSS_CONFIG = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=8,
                   ffn_dim=64, max_seq_len=S)


def _bert_params(config_kw, seed):
    cfg = jbert.BertConfig(compute_dtype=jnp.float32, **config_kw)
    params = jbert.init(cfg, jax.random.key(seed))
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=1)
def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    keep = rng.integers(0, 2, (B, S))
    # Key 0 stays unpadded, so that every query has a causally visible
    # live key (with none, implementations differ on degenerate rows).
    keep[:, 0] = 1
    bias = np.where(keep[:, None, None, :] > 0, 0.0,
                    jra.NEG_INF).astype(np.float32)
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    mask = rng.integers(0, 2, (B, S)).astype(np.int32)
    loss_ids = rng.integers(0, 64, (B, S)).astype(np.int32)
    loss_targets = np.where(rng.random((B, S)) < 0.15, loss_ids,
                            jbert.IGNORE_ID).astype(np.int32)
    return {"q": q, "k": k, "v": v, "do": do, "bias": bias,
            "bert_config": APPLY_CONFIG,
            "bert_params": _bert_params(APPLY_CONFIG, 0)[2],
            "bert_ids": ids, "bert_mask": mask,
            "loss_config": LOSS_CONFIG,
            "loss_params": _bert_params(LOSS_CONFIG, 1)[2],
            "loss_ids": loss_ids, "loss_targets": loss_targets}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: every rank's outputs}, both worlds run at once."""
    worlds = {n: world.start_world(n, "ring", _inputs(),
                                   str(tmp_path_factory.mktemp(f"ring{n}")))
              for n in WORLD_SIZES}
    return {n: w.join(JOIN_TIMEOUT_S) for n, w in worlds.items()}


def _seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _cat(chunks, key, dim):
    return np.concatenate([c[key].numpy() for c in chunks], axis=dim)


def _jax_out_and_grads(fn, with_bias):
    """``fn``'s output and the gradients of ``sum(out ** 2)`` in q, k, v
    (and the bias), in one jit."""
    x = _inputs()
    args = [jnp.asarray(x[n]) for n in "qkv"]
    if with_bias:
        args.append(jnp.asarray(x["bias"]))

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(lambda *a: fn(*a[:3], a[3] if with_bias else None),
                           *args)
        return out, vjp(2 * out)

    out, grads = run(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check_case(chunks, fn, with_bias, merge):
    out, grads = _jax_out_and_grads(fn, with_bias)
    np.testing.assert_allclose(merge(chunks, "out", 2), out, rtol=FWD_TOL,
                               atol=FWD_TOL)
    names = ["dq", "dk", "dv"] + (["dbias"] if with_bias else [])
    for name, want in zip(names, grads):
        got = merge(chunks, name, 3 if name == "dbias" else 2)
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", list(world.ATTENTION_CASES))
def test_attention_matches_jax(ranks, case, n):
    strategy, causal, with_bias, use_flash = world.ATTENTION_CASES[case]
    impl = (jra.ring_self_attention if strategy == "ring"
            else jra.ulysses_attention)
    mesh = _seq_mesh(n)

    def fn(q, k, v, bias):
        return impl(q, k, v, mesh, "seq", bias=bias, causal=causal,
                    use_flash=use_flash)

    chunks = [r[case] for r in ranks[n]]
    assert [c["coords"] for c in chunks] == [[0, r] for r in range(n)]
    _check_case(chunks, fn, with_bias, _cat)


def test_ring_with_data_and_seq_axes(ranks):
    """Batch split over 'data' and sequence over 'seq' at once (2 x 2)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "seq"))

    def fn(q, k, v, bias):
        return jra.ring_self_attention(q, k, v, mesh, "seq", bias=bias,
                                       batch_axis="data")

    chunks = [r["data_seq"] for r in ranks[4]]

    def merge(chunks, key, dim):
        rows = [[c for c in chunks if c["coords"][0] == d] for d in range(2)]
        for row in rows:
            assert [c["coords"][1] for c in row] == [0, 1]
        return np.concatenate([_cat(row, key, dim) for row in rows], axis=0)

    _check_case(chunks, fn, True, merge)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", ["ring_flash_causal", "ulysses_flash_causal"])
def test_flash_with_causal_raises(ranks, case, n):
    impl = (jra.ring_self_attention if case.startswith("ring")
            else jra.ulysses_attention)
    q = jnp.asarray(_inputs()["q"])
    with pytest.raises(ValueError, match="causal"):
        impl(q, q, q, _seq_mesh(n), "seq", causal=True, use_flash=True)
    for r in ranks[n]:
        assert r[case].startswith("ValueError") and "causal" in r[case]


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ulysses_rejects_indivisible_heads(ranks, n):
    q = jnp.asarray(_inputs()["q"])[:, :3]
    with pytest.raises(ValueError, match="divisible"):
        jra.ulysses_attention(q, q, q, _seq_mesh(n), "seq")
    for r in ranks[n]:
        msg = r["ulysses_indivisible"]
        assert msg.startswith("ValueError") and "divisible" in msg


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_bert_apply_matches_jax(ranks, strategy, n):
    x = _inputs()
    cfg, params, _ = _bert_params(APPLY_CONFIG, 0)
    attention_fn = jra.make_attention_fn(_seq_mesh(n), "seq",
                                         strategy=strategy)
    want = jax.jit(lambda p, i, m: jbert.apply(
        cfg, p, i, m, attention_fn=attention_fn))(
            params, jnp.asarray(x["bert_ids"]), jnp.asarray(x["bert_mask"]))
    got = np.concatenate([r[f"bert_apply_{strategy}"].numpy()
                          for r in ranks[n]], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=APPLY_TOL,
                               atol=APPLY_TOL)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_bert_loss_and_grads_match_jax(ranks, n):
    x = _inputs()
    cfg, params, _ = _bert_params(LOSS_CONFIG, 1)
    attention_fn = jra.make_attention_fn(_seq_mesh(n), "seq")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jbert.loss_fn(
        cfg, p, jnp.asarray(x["loss_ids"]), jnp.asarray(x["loss_targets"]),
        attention_fn=attention_fn)))(params)
    got_loss = sum(float(r["bert_loss"]) for r in ranks[n])
    np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_RTOL)
    want = _flat(grads)
    assert set(ranks[n][0]["bert_grads"]) == set(want)
    for name, w in want.items():
        got = sum(r["bert_grads"][name] for r in ranks[n]).numpy()
        np.testing.assert_allclose(got, w, rtol=BERT_GRAD_RTOL,
                                   atol=BERT_GRAD_ATOL, err_msg=name)


# -- the one-process walk of chip_smoke.py ----------------------------------


def _walk_inputs(dtype, device):
    x = _inputs()
    q, k, v, do = (torch.from_numpy(x[n]).to(device, dtype)
                   for n in ("q", "k", "v", "do"))
    return q, k, v, do, torch.from_numpy(x["bias"]).to(device)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_ring_walk_matches_whole_sequence_attention(n, flash):
    """The queries of the whole sequence walk n K/V chunks: the output and
    every gradient equal whole-sequence attention's (JAX's
    ``_full_attention`` differentiated by ``jax.vjp``)."""
    q, k, v, do, bias = _walk_inputs(torch.float32, "cpu")
    out, dq, dk, dv, dbias = tra.ring_walk(
        q, k.chunk(n, 2), v.chunk(n, 2), bias.chunk(n, 3), do,
        use_flash=flash)
    want, vjp = jax.vjp(jra._full_attention, *(
        jnp.asarray(t.numpy()) for t in (q, k, v, bias)))
    grads = vjp(jnp.asarray(do.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for got, w in zip((dq, torch.cat(dk, 2), torch.cat(dv, 2),
                       torch.cat(dbias, 3)), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_causal_ring_walk_per_rank_matches_jax(n):
    """Each rank's walk over the chunks with the causal mask (its own query
    chunk, its own index); the dk chunks summed over the ranks."""
    q, k, v, do, bias = _walk_inputs(torch.float32, "cpu")
    outs, dqs, dks = [], [], [torch.zeros_like(c) for c in k.chunk(n, 2)]
    for r in range(n):
        out, dq, dk, _, _ = tra.ring_walk(
            q.chunk(n, 2)[r], k.chunk(n, 2), v.chunk(n, 2), bias.chunk(n, 3),
            do.chunk(n, 2)[r], index=r, causal=True)
        outs.append(out)
        dqs.append(dq)
        dks = [a + b for a, b in zip(dks, dk)]
    pos = jnp.arange(S)
    mask = jnp.asarray(bias.numpy()) + jra.causal_bias(pos, pos)
    want, vjp = jax.vjp(lambda q, k: jra._full_attention(
        q, k, jnp.asarray(v.numpy()), mask), jnp.asarray(q.numpy()),
        jnp.asarray(k.numpy()))
    want_dq, want_dk = vjp(jnp.asarray(do.numpy()))
    for got, w, tol in ((torch.cat(outs, 2), want, FWD_TOL),
                        (torch.cat(dqs, 2), want_dq, GRAD_TOL),
                        (torch.cat(dks, 2), want_dk, GRAD_TOL)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_flash_ring_walk_matches_flash_attention(n, with_bias):
    """The smoke's ``ring`` check at B=2, H=8, S=64 (D=16), bf16: the flash
    ring over n chunks launches each kernel n times and agrees with
    whole-sequence ``flash_attention`` within the flash checks' 2e-2
    absolute plus 2e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, bias = _walk_inputs(torch.bfloat16, "cuda")
    if not with_bias:
        bias = None
    tfa.reset_launch_counts()
    out, dq, dk, dv, dbias = tra.ring_walk(
        q, k.chunk(n, 2), v.chunk(n, 2),
        None if bias is None else bias.chunk(n, 3), do, use_flash=True)
    assert tfa.launch_counts == {"flash_fwd": n, "flash_dq": n,
                                 "flash_dkv": n}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bias_leaf = None if bias is None else bias.clone().requires_grad_(True)
    want = tfa.flash_attention(*leaves, bias_leaf)
    want.backward(do)
    got = [out, dq, torch.cat(dk, 2), torch.cat(dv, 2)]
    ref = [want, *(t.grad for t in leaves)]
    if bias is not None:
        got.append(torch.cat(dbias, 3))
        ref.append(bias_leaf.grad)
    for g, w in zip(got, ref):
        w = w.float()
        assert bool(((g.float() - w).abs() <= 2e-2 + 2e-2 * w.abs()).all())
