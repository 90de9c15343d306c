"""The port's BERT MLM model, masking and data generator against the JAX
package's.

The JAX package's parameters (``bert.init``) load into the port through
``weights.bert_from_jax_params``; the same token ids and attention mask go
to both. In f32 compute the logits agree within 2e-4 with inline and with
flash attention (the JAX package's own flash-vs-inline tolerance), the loss
within 1e-5 relative and the gradients within 1e-4 relative (atol 1e-6):
both sum the same products in another order. Masking is compared bit for
bit by feeding the port's 80/10/10 rule JAX's own three draws; the port's
own draws are held to the rule's rates within a stated band.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.models import bert as jbert
from ray_shuffling_data_loader_tpu.ops import flash_attention as jfa
from ray_shuffling_data_loader_tpu.workloads import bert_mlm as jmlm
from ray_shuffling_data_loader_tpu_torch import weights
from ray_shuffling_data_loader_tpu_torch.models import bert as tbert
from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as tfa
from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm as tmlm

B, S = 2, 32


def _configs(remat=False):
    jcfg = jbert.BertConfig(vocab_size=1000, hidden_dim=64, num_layers=2,
                            num_heads=4, ffn_dim=128, max_seq_len=64,
                            compute_dtype=jnp.float32, remat=remat)
    tcfg = tbert.BertConfig(vocab_size=1000, hidden_dim=64, num_layers=2,
                            num_heads=4, ffn_dim=128, max_seq_len=64,
                            compute_dtype=torch.float32, remat=remat)
    return jcfg, tcfg


def _models(remat=False, seed=0):
    jcfg, tcfg = _configs(remat)
    params = jbert.init(jcfg, jax.random.key(seed))
    model = tbert.Bert(tcfg, device="cpu")
    model.load_state_dict(weights.bert_from_jax_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    # Ids past the vocab are clamped by both models.
    ids = rng.integers(0, 1010, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    targets = np.where(rng.random((B, S)) < 0.3, ids % 1000,
                       jbert.IGNORE_ID).astype(np.int32)
    return ids, mask, targets


@pytest.mark.parametrize("flash", [False, True])
def test_logits_match_jax(flash):
    jcfg, params, model = _models()
    ids, mask, _ = _batch()
    jfn = jfa.make_flash_attention_fn(block_q=16, block_k=16) if flash \
        else None
    tfn = tfa.make_flash_attention_fn() if flash else None
    want = jbert.apply(jcfg, params, jnp.asarray(ids), jnp.asarray(mask),
                       attention_fn=jfn)
    with torch.no_grad():
        got = tbert.apply(model, torch.from_numpy(ids),
                          torch.from_numpy(mask), attention_fn=tfn)
    assert got.dtype == torch.float32 and got.shape == (B, S, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _named_jax_leaf(params, name):
    node = params
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_gradients_match_jax(flash):
    jcfg, params, model = _models(seed=1)
    ids, mask, targets = _batch(seed=1)
    jfn = jfa.make_flash_attention_fn(block_q=16, block_k=16) if flash \
        else None
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jbert.loss_fn(jcfg, p, jnp.asarray(ids),
                                jnp.asarray(targets), jnp.asarray(mask),
                                attention_fn=jfn))(params)
    loss = tbert.loss_fn(model, torch.from_numpy(ids),
                         torch.from_numpy(targets), torch.from_numpy(mask),
                         attention_fn=tfa.make_flash_attention_fn()
                         if flash else None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), _named_jax_leaf(want_grads, name), rtol=1e-4,
            atol=1e-6, err_msg=name)


def test_loss_ignores_unselected_positions_and_clamps_the_count():
    _, _, model = _models()
    ids, _, _ = _batch()
    none = torch.full((B, S), tbert.IGNORE_ID, dtype=torch.int32)
    assert tbert.loss_fn(model, torch.from_numpy(ids), none).item() == 0.0


def test_remat_gives_the_same_gradients():
    grads = []
    for remat in (False, True):
        _, _, model = _models(remat=remat, seed=2)
        ids, mask, targets = _batch(seed=2)
        tbert.loss_fn(model, torch.from_numpy(ids),
                      torch.from_numpy(targets), torch.from_numpy(mask),
                      attention_fn=tfa.make_flash_attention_fn()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-6,
                                   atol=1e-7, msg=name)


def test_bert_from_jax_params_rejects_bad_trees():
    jcfg, tcfg = _configs()
    params = jax.tree_util.tree_map(np.asarray,
                                    jbert.init(jcfg, jax.random.key(0)))
    missing = dict(params)
    del missing["mlm_bias"]
    with pytest.raises(ValueError, match="missing"):
        weights.bert_from_jax_params(tcfg, missing)
    extra = dict(params, extra=np.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        weights.bert_from_jax_params(tcfg, extra)
    wrong = dict(params, pos_emb=np.zeros((8, 64)))
    with pytest.raises(ValueError, match="pos_emb"):
        weights.bert_from_jax_params(tcfg, wrong)


def test_model_init_is_seeded_and_named_like_jax():
    _, tcfg = _configs()
    a = tbert.Bert(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    b = tbert.Bert(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p, q, msg=name)
    assert set(a.state_dict()) == set(weights.bert_from_jax_params(
        tcfg, jax.tree_util.tree_map(
            np.asarray, jbert.init(_configs()[0], jax.random.key(0)))))
    assert tbert.bert_base().head_dim == 64 and tbert.bert_tiny().head_dim \
        == 16


@pytest.mark.parametrize("seed", [0, 7])
def test_mlm_rule_on_jax_draws_equals_jax_mask(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 1000, (8, 128)).astype(np.int32)
    tokens[:, 0] = jmlm.CLS_ID
    key = jax.random.key(seed)
    want_inputs, want_targets = jmlm.mlm_mask(jnp.asarray(tokens), key, 1000)
    select_key, action_key, random_key = jax.random.split(key, 3)
    select_u = jax.random.uniform(select_key, tokens.shape)
    action_u = jax.random.uniform(action_key, tokens.shape)
    random_tokens = jax.random.randint(random_key, tokens.shape,
                                       jmlm.NUM_SPECIAL_TOKENS, 1000,
                                       dtype=jnp.int32)
    inputs, targets = tmlm.apply_mlm_rule(
        torch.from_numpy(tokens), torch.from_numpy(np.array(select_u)),
        torch.from_numpy(np.array(action_u)),
        torch.from_numpy(np.array(random_tokens)))
    assert inputs.dtype == targets.dtype == torch.int32
    np.testing.assert_array_equal(inputs.numpy(), np.asarray(want_inputs))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(want_targets))


def test_mlm_rule_edges():
    tokens = torch.tensor([[1, 4, 5, 6, 7, 8]], dtype=torch.int32)
    select = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.15, 0.149]])
    action = torch.tensor([[0.0, 0.7999, 0.8, 0.8999, 0.0, 0.9]])
    rand = torch.full_like(tokens, 99)
    inputs, targets = tmlm.apply_mlm_rule(tokens, select, action, rand)
    # [CLS] is special: never selected. 0.15 is not < mask_prob.
    assert inputs.tolist() == [[1, tmlm.MASK_ID, 5, 6, 7, 99]]
    assert targets.tolist() == [[tbert.IGNORE_ID, 4, 5, 6, tbert.IGNORE_ID,
                                 8]]


def test_mlm_mask_rates_with_the_port_draws():
    # 64 x 4096 tokens: about 39,000 selected, so each rate's standard
    # error is at most 0.0025; the band is 0.01 (4 standard errors).
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(4, 1000, (64, 4096), generator=gen,
                           dtype=torch.int32)
    tokens[:, 0] = tmlm.CLS_ID
    inputs, targets = tmlm.mlm_mask(tokens, torch.Generator().manual_seed(1),
                                    1000)
    selected = targets != tbert.IGNORE_ID
    assert not selected[:, 0].any()
    assert torch.equal(targets[selected], tokens[selected])
    assert torch.equal(inputs[~selected], tokens[~selected])
    n = selected.sum().item()
    assert abs(n / (64 * 4095) - 0.15) < 0.01
    masked = (inputs[selected] == tmlm.MASK_ID).sum().item() / n
    kept = (inputs[selected] == tokens[selected]).sum().item() / n
    assert abs(masked - 0.8) < 0.01
    assert abs(kept - 0.1) < 0.01  # plus random draws equal to the token
    assert abs(1 - masked - kept - 0.1) < 0.01
    again = tmlm.mlm_mask(tokens, torch.Generator().manual_seed(1), 1000)
    assert torch.equal(again[0], inputs) and torch.equal(again[1], targets)


def test_generated_files_equal_jax(tmp_path):
    got, got_bytes = tmlm.generate_tokenized_parquet(
        1000, 3, str(tmp_path / "port"), seq_len=24, vocab_size=500, seed=3)
    want, want_bytes = jmlm.generate_tokenized_parquet(
        1000, 3, str(tmp_path / "jax"), seq_len=24, vocab_size=500, seed=3)
    assert [p.split("/")[-1] for p in got] == \
        [p.split("/")[-1] for p in want]
    assert got_bytes == want_bytes
    for a, b in zip(got, want):
        assert filecmp.cmp(a, b, shallow=False), a
    (tmp_path / "one").mkdir()
    (tmp_path / "one_jax").mkdir()
    path, nbytes = tmlm.generate_file(2, 700, 50, str(tmp_path / "one"), 24,
                                      500, 3)
    assert filecmp.cmp(path, jmlm.generate_file(
        2, 700, 50, str(tmp_path / "one_jax"), 24, 500, 3)[0], shallow=False)
    assert nbytes > 0
