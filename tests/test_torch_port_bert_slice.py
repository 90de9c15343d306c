"""The port's BERT-MLM train path as a whole against the JAX package's.

Both packages shuffle the same tokenized Parquet files (seeded); the
``(B, S)`` int32 token batches must be equal, bit for bit, over 2 epochs and
under ``skip_batches``. Then both train the same ``bert_tiny`` parameters
(f32 compute, flash attention) with Adam (lr 1e-4) for 3 micro-steps on the
first batch, each micro-step masked with the same draws (JAX's own, fed to
the port's 80/10/10 rule). The losses agree within 1e-5 relative and the
parameters within 1e-4 relative (atol 1e-6), as in the DLRM slice test:
``torch.optim.Adam`` and ``optax.adam`` round in a different order.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.models import bert as jbert
from ray_shuffling_data_loader_tpu.ops import flash_attention as jfa
from ray_shuffling_data_loader_tpu.workloads import bert_mlm as jmlm
from ray_shuffling_data_loader_tpu_torch import train, weights
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.models import bert as tbert
from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as tfa
from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm as tmlm

NUM_SEQS, NUM_FILES, SEQ_LEN, VOCAB = 3000, 3, 32, 1000
BATCH, NUM_EPOCHS, NUM_REDUCERS, SEED = 120, 2, 3, 5
MICRO, LR = 40, 1e-4

_queue_ids = itertools.count()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_bert"))
    filenames, _ = tmlm.generate_tokenized_parquet(
        NUM_SEQS, NUM_FILES, d, seq_len=SEQ_LEN, vocab_size=VOCAB, seed=SEED)
    return filenames


def _jax_stream(files, skips):
    ds = JaxShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        num_workers=1, device_rebatch=False,
        queue_name=f"torch-port-bert-{next(_queue_ids)}",
        **jmlm.bert_mlm_spec(SEQ_LEN))
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch, skip_batches=skips.get(epoch, 0))
        out.append([(np.asarray(f[0]), np.asarray(label)) for f, label in ds])
    ds.close()
    return out


def _port_stream(files, skips):
    ds = DeviceShufflingDataset(
        files, NUM_EPOCHS, 1, BATCH, 0, num_reducers=NUM_REDUCERS, seed=SEED,
        device="cpu", **tmlm.bert_mlm_spec(SEQ_LEN))
    out = []
    for epoch in range(NUM_EPOCHS):
        ds.set_epoch(epoch, skip_batches=skips.get(epoch, 0))
        out.append([(f[0].numpy(), label.numpy()) for f, label in ds])
    return out


@pytest.mark.parametrize("skips", [{}, {0: 3, 1: 11}])
def test_token_stream_equals_jax(files, skips):
    port, ref = _port_stream(files, skips), _jax_stream(files, skips)
    for epoch in range(NUM_EPOCHS):
        assert len(port[epoch]) == len(ref[epoch]) == \
            NUM_SEQS // BATCH - skips.get(epoch, 0)
        for (pt, pl), (rt, rl) in zip(port[epoch], ref[epoch]):
            assert pt.shape == rt.shape == (BATCH, SEQ_LEN)
            assert pt.dtype == rt.dtype == np.int32
            np.testing.assert_array_equal(pt, rt)
            assert pl.dtype == rl.dtype == np.int32
            np.testing.assert_array_equal(pl, rl)
    assert not np.array_equal(port[0][0][0], port[1][0][0])


def _jax_draws(tokens, key):
    select_key, action_key, random_key = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.uniform(select_key,
                                                         tokens.shape))),
            torch.from_numpy(np.array(jax.random.uniform(action_key,
                                                         tokens.shape))),
            torch.from_numpy(np.array(jax.random.randint(
                random_key, tokens.shape, tmlm.NUM_SPECIAL_TOKENS, VOCAB,
                dtype=jnp.int32))))


def test_three_adam_steps_match_optax(files):
    tokens = _port_stream(files, {})[0][0][0]
    jcfg = dataclasses.replace(jbert.bert_tiny(), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tbert.bert_tiny(),
                               compute_dtype=torch.float32)
    params = jbert.init(jcfg, jax.random.key(3))
    model = tbert.Bert(tcfg, device="cpu")
    model.load_state_dict(weights.bert_from_jax_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params)))
    jfn = jfa.make_flash_attention_fn(block_q=16, block_k=16)

    opt = optax.adam(LR)
    opt_state = opt.init(params)

    @jax.jit
    def jstep(params, opt_state, tokens, key):
        inputs, targets = jmlm.mlm_mask(tokens, key, VOCAB)
        loss, grads = jax.value_and_grad(
            lambda p: jbert.loss_fn(jcfg, p, inputs, targets,
                                    attention_fn=jfn))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    optimizer = train.make_optimizer(model, lr=train.BERT_LR)
    assert train.BERT_LR == LR
    update = train.make_bert_update(model, optimizer,
                                    tfa.make_flash_attention_fn())
    want, got = [], []
    for step, lo in enumerate(range(0, BATCH, MICRO)):
        micro = tokens[lo:lo + MICRO]
        key = jax.random.key(100 + step)
        params, opt_state, loss = jstep(params, opt_state,
                                        jnp.asarray(micro), key)
        want.append(float(loss))
        inputs, targets = tmlm.apply_mlm_rule(torch.from_numpy(micro),
                                              *_jax_draws(micro, key))
        got.append(update(inputs, targets).item())
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, p in model.named_parameters():
        ref = params
        for part in name.split("."):
            ref = ref[part]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_bert_micro_step_masks_on_the_device_and_trains(files):
    tokens = torch.from_numpy(_port_stream(files, {})[0][0][0])
    cfg = dataclasses.replace(tbert.bert_tiny(), compute_dtype=torch.float32)
    model = tbert.Bert(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    step = train.make_bert_micro_step(
        model, train.make_optimizer(model, lr=train.BERT_LR),
        torch.Generator().manual_seed(1), tfa.make_flash_attention_fn())
    before = model.token_emb.detach().clone()
    losses = train.train_chunk(step, [tokens], torch.zeros(BATCH, 1), MICRO)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert not torch.equal(before, model.token_emb)
    # Random tokens over a 1000-word vocab: the loss starts near ln(1000).
    assert abs(losses[0].item() - np.log(VOCAB)) < 0.5
