"""The port's mesh, data-parallel trainer and sequence-parallel BERT path
against the JAX package's ``parallel/`` and its sequence-parallel dry run.

The port side runs in spawned gloo worlds (``torch_port_world``), each
once for the whole file: a world of 2 on a ``("data", "model")`` mesh of
(2, 1) trains DLRM, and a world of 4 on a ``("data", "seq")`` mesh of
(2, 2) trains the dry run's tiny BERT with ring attention, reads the
loader streams and takes one sequence-parallel micro-step. The JAX side
runs ``SpmdTrainer`` on meshes of the same shapes of the conftest's
8-device CPU platform, from the same parameters (``weights.*from_jax``)
and global batches.

Tolerances: the DLRM losses within 1e-5 relative (the DLRM slice test's:
``torch.optim.Adam`` and ``optax.adam`` round in another order), the BERT
losses within 1e-4 relative (the ring test's loss tolerance); the
replicas of every rank hold equal parameters, bit for bit; the loader
streams are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_world as world
from ray_shuffling_data_loader_tpu.models import bert as jbert
from ray_shuffling_data_loader_tpu.models import dlrm as jdlrm
from ray_shuffling_data_loader_tpu.parallel import mesh as jmesh
from ray_shuffling_data_loader_tpu.parallel import trainer as jtrainer
from ray_shuffling_data_loader_tpu.ops import ring_attention as jra
from ray_shuffling_data_loader_tpu_torch import weights
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.models import bert as tbert
from ray_shuffling_data_loader_tpu_torch.models import dlrm as tdlrm
from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptrainer
from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm as tmlm

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


DLRM_RTOL, BERT_RTOL = 1e-5, 1e-4
JOIN_TIMEOUT_S = 240
STEPS = 3
DLRM_CONFIG = dict(vocab_sizes=(3000, 50, 7, 300), embed_dim=8,
                   top_hidden=(16, 8), lookup_mode="auto")
DLRM_BATCH = 64
# The dry run's BERT (__graft_entry__._dryrun_impl): 2 x 2 mesh, S = 8 * 2.
BERT_CONFIG = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=4,
                   ffn_dim=64, max_seq_len=16)
BERT_BATCH, BERT_SEQ = 4, 16
LOADER = {"files": None, "seq_len": 16,
          "kw": dict(num_epochs=2, batch_size=24, drop_last=False,
                     num_reducers=4, seed=3)}
LOADER_ROWS, LOADER_VOCAB, MASK_SEED = 200, 64, 7


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    jd = jdlrm.DLRMConfig(compute_dtype=jnp.float32, **DLRM_CONFIG)
    dlrm_params = jdlrm.init(jd, jax.random.key(2))
    dlrm_batches = [
        (np.stack([rng.integers(-3, v + 3, DLRM_BATCH)
                   for v in jd.vocab_sizes], axis=1).astype(np.int32),
         rng.random((DLRM_BATCH, 1)).astype(np.float32))
        for _ in range(STEPS)]
    jb = jbert.BertConfig(compute_dtype=jnp.float32, **BERT_CONFIG)
    bert_params = jbert.init(jb, jax.random.key(1))
    tokens = [rng.integers(0, 64, (BERT_BATCH, BERT_SEQ)).astype(np.int32)
              for _ in range(STEPS)]
    targets = [np.where(rng.random(t.shape) < 0.15, t,
                        jbert.IGNORE_ID).astype(np.int32) for t in tokens]
    files, _ = tmlm.generate_tokenized_parquet(
        LOADER_ROWS, 3, str(tmp_path_factory.mktemp("sp_loader")),
        seq_len=LOADER["seq_len"], vocab_size=LOADER_VOCAB, seed=4)
    return {"dlrm_config": DLRM_CONFIG, "dlrm_params": _np_tree(dlrm_params),
            "dlrm_batches": dlrm_batches, "jax_dlrm": (jd, dlrm_params),
            "bert_config": BERT_CONFIG, "bert_params": _np_tree(bert_params),
            "bert_tokens": tokens, "bert_targets": targets,
            "jax_bert": (jb, bert_params),
            "loader": {**LOADER, "files": files}, "mask_seed": MASK_SEED}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{"dlrm": 2 ranks' outputs, "seq": 4 ranks'}, both worlds at once."""
    sent = {k: v for k, v in inputs.items() if not k.startswith("jax_")}
    worlds = {name: world.start_world(n, name, sent, str(
        tmp_path_factory.mktemp(name))) for name, n in (("dlrm", 2),
                                                        ("seq", 4))}
    return {name: w.join(JOIN_TIMEOUT_S) for name, w in worlds.items()}


@pytest.mark.parametrize("mesh_name,names,sizes", [
    ("dp", ("data", "model"), [2, 1]),
    ("mp", ("data", "model"), [1, 2]),
])
def test_make_mesh_axes(ranks, mesh_name, names, sizes):
    for rank, out in enumerate(ranks["dlrm"]):
        info = out[mesh_name]
        assert info["names"] == names and info["sizes"] == sizes
        want_index = [rank, 0] if mesh_name == "dp" else [0, rank]
        assert info["index"] == want_index
        assert info["shard_info"] == (want_index[0], sizes[0])


def test_data_seq_mesh_axes_and_loader_ranks(ranks):
    for rank, out in enumerate(ranks["seq"]):
        info = out["mesh"]
        assert info["names"] == ("data", "seq") and info["sizes"] == [2, 2]
        assert info["index"] == [rank // 2, rank % 2]
        assert info["shard_info"] == (rank // 2, 2)


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.named_mesh((1, 1), ("data", "seq"))


def test_trainer_rejects_param_specs():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        ptrainer.SpmdTrainer(None, lambda m: m.weight.sum(), model,
                             torch.optim.Adam(model.parameters()),
                             param_specs={"weight": ("model",)})


def _jax_trainer_losses(trainer, mesh, batches, spec):
    """The JAX trainer's losses over global 2-D batches placed by ``spec``."""
    sharding = NamedSharding(mesh, spec)
    return np.asarray([float(trainer.train_step(*(
        jax.device_put(jnp.asarray(a), sharding) for a in batch)))
        for batch in batches])


def _replicas_equal(outs):
    for out in outs[1:]:
        assert torch.equal(out["params"], outs[0]["params"])


def test_dlrm_data_parallel_matches_jax_spmd_trainer(inputs, ranks):
    """Three Adam steps on a 2-rank data axis (rank 1 starts from other
    parameters: the trainer broadcasts rank 0's)."""
    jd, params = inputs["jax_dlrm"]
    mesh = jmesh.make_mesh(2)
    trainer = jtrainer.SpmdTrainer(
        mesh, lambda p, sparse, labels: jdlrm.loss_fn(jd, p, None, sparse,
                                                      labels),
        params, optax.adam(1e-3))
    want = _jax_trainer_losses(trainer, mesh, inputs["dlrm_batches"],
                               P("data", None))
    for out in ranks["dlrm"]:
        np.testing.assert_allclose(out["losses"].numpy(), want,
                                   rtol=DLRM_RTOL)
    _replicas_equal(ranks["dlrm"])


def test_sequence_parallel_bert_dryrun_matches_jax(inputs, ranks):
    """``__graft_entry__._dryrun_impl``'s BERT case: ring attention over
    ``seq`` with the batch over ``data``, three Adam steps."""
    jb, params = inputs["jax_bert"]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "seq"))
    attention_fn = jra.make_attention_fn(mesh, "seq", batch_axis="data")
    trainer = jtrainer.SpmdTrainer(
        mesh, lambda p, tokens, targets: jbert.loss_fn(
            jb, p, tokens, targets, attention_fn=attention_fn),
        params, optax.adam(1e-3))
    want = _jax_trainer_losses(
        trainer, mesh, zip(inputs["bert_tokens"], inputs["bert_targets"]),
        P("data", "seq"))
    for out in ranks["seq"]:
        np.testing.assert_allclose(out["losses"].numpy(), want,
                                   rtol=BERT_RTOL)
    _replicas_equal(ranks["seq"])


def _one_rank_streams(inputs):
    loader = inputs["loader"]
    ds = DeviceShufflingDataset(loader["files"], num_trainers=1, rank=0,
                                device="cpu", **loader["kw"],
                                **tmlm.bert_mlm_spec(loader["seq_len"]))
    streams = []
    for epoch in range(loader["kw"]["num_epochs"]):
        ds.set_epoch(epoch)
        streams.append([f[0] for f, _ in ds])
    return streams


def test_seq_peers_read_the_same_stream(ranks):
    outs = ranks["seq"]
    for data_rank in range(2):
        peers = [outs[2 * data_rank + s]["streams"] for s in range(2)]
        for a, b in zip(*peers):
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_data_ranks_together_read_the_one_rank_stream(inputs, ranks):
    """Rank k reads the k-th span of each epoch's reducers, so the data
    ranks' rows, in rank order, are the one-rank stream's rows."""
    one = _one_rank_streams(inputs)
    outs = ranks["seq"]
    for epoch, want in enumerate(one):
        got = torch.cat([torch.cat(outs[2 * d]["streams"][epoch])
                         for d in range(2)])
        want = torch.cat(want)
        assert got.shape == (LOADER_ROWS, LOADER["seq_len"])
        assert torch.equal(got, want)
    assert not torch.equal(torch.cat(one[0]), torch.cat(one[1]))


def test_spmd_micro_step_masks_the_whole_batch_then_chunks(inputs, ranks):
    """The micro-step's global loss equals one process's loss over the two
    data ranks' first batches, each masked whole with the seed the peers
    share: the seq peers drew the same masks before taking their chunks."""
    model = tbert.Bert(tbert.BertConfig(compute_dtype=torch.float32,
                                        **BERT_CONFIG), device="cpu")
    model.load_state_dict(weights.bert_from_jax_params(
        model.config, inputs["bert_params"]))
    masked = [tmlm.mlm_mask(ranks["seq"][2 * d]["streams"][0][0],
                            torch.Generator().manual_seed(MASK_SEED),
                            BERT_CONFIG["vocab_size"]) for d in range(2)]
    with torch.no_grad():
        want = tbert.loss_fn(model, torch.cat([m[0] for m in masked]),
                             torch.cat([m[1] for m in masked]))
    for out in ranks["seq"]:
        np.testing.assert_allclose(float(out["micro_loss"]), float(want),
                                   rtol=BERT_RTOL)
