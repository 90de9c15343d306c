"""The port's ``checkpoint.py`` against the JAX package's (the port's
versions of ``tests/test_checkpoint.py``): ``LoaderCheckpoint`` files
cross between the packages both ways, a mid-epoch resume replays exactly
the remaining batches (the JAX package's resumed stream), progress
persists at least once, and save, restore and continue equals an
uninterrupted run bit for bit on the CPU: an MLP with SGD, and a tiny
BERT with Adam and its mask generator.
"""

import itertools
import types

import jax  # noqa: F401  (imported before any worker thread needs it)
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu import checkpoint as jckpt
from ray_shuffling_data_loader_tpu import dataset as jds
from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
from ray_shuffling_data_loader_tpu_torch import data_generation as tdg
from ray_shuffling_data_loader_tpu_torch import dataset as tds
from ray_shuffling_data_loader_tpu_torch import shuffle as tsh
from ray_shuffling_data_loader_tpu_torch import train
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.models import bert, mlp
from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm
from ray_shuffling_data_loader_tpu_torch.workloads.dlrm_criteo import (
    dlrm_spec)

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


_queue_ids = itertools.count()


def make_checkpoint(cls=ckpt.LoaderCheckpoint, **overrides):
    base = dict(seed=11, epoch=0, batches_consumed=0, num_epochs=3,
                num_trainers=1, rank=0, batch_size=20)
    base.update(overrides)
    return cls(**base)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three files of 60 rows (keys 0..179)."""
    d = str(tmp_path_factory.mktemp("ckpt_files"))
    return tdg.generate_data(180, 3, d, seed=0)[0]


def test_save_load_roundtrip(tmp_path):
    c = make_checkpoint(epoch=2, batches_consumed=5)
    path = str(tmp_path / "ckpt.json")
    c.save(path)
    assert ckpt.LoaderCheckpoint.load(path) == c
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.json"]


def test_load_rejects_bad_version(tmp_path):
    c = make_checkpoint()
    c.version = 99
    path = str(tmp_path / "ckpt.json")
    c.save(path)
    with pytest.raises(ValueError, match="version"):
        ckpt.LoaderCheckpoint.load(path)


def test_loader_checkpoint_files_cross_between_packages(tmp_path):
    fields = dict(epoch=1, batches_consumed=7, seed=3, num_trainers=2,
                  rank=1)
    ours = str(tmp_path / "port.json")
    make_checkpoint(**fields).save(ours)
    assert jckpt.LoaderCheckpoint.load(ours) == make_checkpoint(
        jckpt.LoaderCheckpoint, **fields)
    theirs = str(tmp_path / "jax.json")
    make_checkpoint(jckpt.LoaderCheckpoint, **fields).save(theirs)
    assert ckpt.LoaderCheckpoint.load(theirs) == make_checkpoint(**fields)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    assert ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION


def _dataset(files, seed=11, num_epochs=3, batch_size=20, start_epoch=0):
    return tds.ShufflingDataset(files, num_epochs, 1, batch_size, 0,
                                num_reducers=3, seed=seed,
                                start_epoch=start_epoch)


def _keys(batches):
    return [b.column("key").to_pylist() for b in batches]


def _run_full(files, seed=11, num_epochs=3):
    d = _dataset(files, seed, num_epochs)
    out = []
    for epoch in range(num_epochs):
        d.set_epoch(epoch)
        out.append(_keys(d))
    return out


def test_resume_mid_epoch_replays_remaining_batches(files):
    full = _run_full(files)
    crash_epoch, crashed = 1, 4
    c = make_checkpoint(epoch=crash_epoch, batches_consumed=crashed)
    got = _keys(ckpt.resume_iterator(
        _dataset(files, start_epoch=crash_epoch), c))
    expected = full[crash_epoch][crashed:] + full[2]
    assert got == expected
    # The JAX package resumes the same files onto the same stream.
    jc = make_checkpoint(jckpt.LoaderCheckpoint, epoch=crash_epoch,
                         batches_consumed=crashed)
    jdata = jds.ShufflingDataset(
        files, num_epochs=3, num_trainers=1, batch_size=20, rank=0,
        num_reducers=3, seed=11, num_workers=1, start_epoch=crash_epoch,
        queue_name=f"torch-port-ckpt-{next(_queue_ids)}")
    assert _keys(jckpt.resume_iterator(jdata, jc)) == expected


def test_resume_persists_progress_at_least_once(files, tmp_path):
    path = str(tmp_path / "ckpt.json")
    c = make_checkpoint(seed=5, num_epochs=2)
    it = ckpt.resume_iterator(_dataset(files, seed=5, num_epochs=2), c,
                              checkpoint_path=path, checkpoint_every=1)
    next(it)
    next(it)
    saved = ckpt.LoaderCheckpoint.load(path)
    # Batch N's save lands when the caller comes back for batch N+1.
    assert saved.epoch == 0 and saved.batches_consumed == 1
    for _ in it:
        pass
    saved = ckpt.LoaderCheckpoint.load(path)
    assert saved.epoch == 2 and saved.batches_consumed == 0


def test_resume_of_finished_run_is_noop():
    c = make_checkpoint(epoch=3, num_epochs=3)

    class Boom:
        batch_size = 20

        def set_epoch(self, *a, **k):
            raise AssertionError("a finished checkpoint must not iterate")

    assert list(ckpt.resume_iterator(Boom(), c)) == []


@pytest.mark.parametrize("field,value", [("seed", 12), ("num_epochs", 4),
                                         ("batch_size", 32)])
def test_mismatch_with_the_dataset_is_rejected(files, field, value):
    d = _dataset(files)
    with pytest.raises(ValueError, match=field):
        next(ckpt.resume_iterator(d, make_checkpoint(**{field: value})))
    d.shutdown()


def test_shuffle_start_epoch_skips_early_epochs(files):
    def collect(start_epoch):
        tables = {}

        def consumer(rank, epoch, futures):
            if futures is not None:
                tables.setdefault(epoch, []).extend(futures)

        tsh.shuffle(files, consumer, num_epochs=3, num_reducers=2,
                    num_trainers=1, seed=3, start_epoch=start_epoch)
        return {e: np.concatenate([f.result().column("key").to_numpy()
                                   for f in fs]) for e, fs in tables.items()}

    resumed, full = collect(2), collect(0)
    assert sorted(resumed) == [2] and sorted(full) == [0, 1, 2]
    np.testing.assert_array_equal(np.sort(resumed[2]), np.arange(180))
    np.testing.assert_array_equal(resumed[2], full[2])


def test_start_epoch_is_validated(files):
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="start_epoch"):
            _dataset(files, num_epochs=2, start_epoch=bad)
        with pytest.raises(ValueError, match="start_epoch"):
            tsh.shuffle(files, lambda *a: None, 2, 2, 1, start_epoch=bad)
    d = _dataset(files, num_epochs=3, batch_size=10, start_epoch=1)
    assert d.start_epoch == 1
    with pytest.raises(ValueError, match="precedes start_epoch"):
        d.set_epoch(0)
    for epoch in (1, 2):
        d.set_epoch(epoch)
        assert sum(b.num_rows for b in d) == 180


# --- Train state.

def _mlp_trainer(seed):
    model = mlp.MLP(4, (8,), 1, compute_dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    optimizer = train.make_optimizer(model)
    return types.SimpleNamespace(model=model, optimizer=optimizer)


def _mlp_step(trainer, x, y):
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = ((trainer.model(x) - y) ** 2).mean()
    loss.backward()
    trainer.optimizer.step()
    return loss.detach()


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_train_state_roundtrip_next_step_is_bit_identical(tmp_path):
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    y = torch.randn(8, 1, generator=torch.Generator().manual_seed(1))
    trainer = _mlp_trainer(0)
    for _ in range(3):
        _mlp_step(trainer, x, y)
    gen = torch.Generator().manual_seed(4)
    torch.rand(3, generator=gen)
    loader = make_checkpoint(epoch=1, batches_consumed=3, batch_size=8)
    with ckpt.TrainStateCheckpointer(str(tmp_path / "ck")) as saver:
        saver.save(3, trainer, loader_checkpoint=loader, generators=[gen])
        assert saver.latest_step() == 3
        other = _mlp_trainer(99)
        other_gen = torch.Generator().manual_seed(5)
        assert saver.restore(other, generators=[other_gen]) == loader
        with pytest.raises(ValueError, match="already exists"):
            saver.save(3, trainer)
        with pytest.raises(ValueError, match="generator"):
            saver.restore(other)
    for name, value in _state(trainer).items():
        assert torch.equal(value, other.model.state_dict()[name]), name
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=other_gen))
    assert torch.equal(_mlp_step(trainer, x, y), _mlp_step(other, x, y))
    for name, value in _state(trainer).items():
        assert torch.equal(value, other.model.state_dict()[name]), name


def test_save_without_loader_restores_none(tmp_path):
    trainer = _mlp_trainer(0)
    with ckpt.TrainStateCheckpointer(str(tmp_path / "ck")) as saver:
        saver.save(1, trainer)
        assert saver.restore(trainer) is None


def test_restore_without_checkpoint_raises(tmp_path):
    with ckpt.TrainStateCheckpointer(str(tmp_path / "ck")) as saver:
        assert saver.latest_step() is None
        with pytest.raises(ValueError, match="no checkpoint"):
            saver.restore(_mlp_trainer(0))


def test_max_to_keep_is_honoured(tmp_path):
    trainer = _mlp_trainer(0)
    saver = ckpt.TrainStateCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (5, 10, 15):
        saver.save(step, trainer)
    assert saver.steps() == [10, 15] and saver.latest_step() == 15
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["10",
                                                                  "15"]
    saver.restore(trainer, step=10)


def _resume_equals_uninterrupted(tmp_path, files, spec, build, batch_size,
                                 crash_epoch, crash_after, num_epochs=2,
                                 made=None, **ds_kw):
    """``build(seed) -> (trainer, step, generators)``. Trains the whole
    run; then trains until ``crash_after`` batches of ``crash_epoch``,
    saves, restores into a trainer built from another seed and finishes
    through ``resume_iterator``. Returns the two runs' losses and final
    parameters; the datasets made go into ``made``."""

    def make_ds(start_epoch=0):
        ds = DeviceShufflingDataset(
            files, num_epochs, 1, batch_size, 0, num_reducers=2, seed=21,
            device="cpu", start_epoch=start_epoch, **ds_kw, **spec)
        if made is not None:
            made.append(ds)
        return ds

    trainer, step, _ = build(0)
    ds = make_ds()
    want = []
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        want.extend(step(cols, label) for cols, label in ds)
    want_state = _state(trainer)

    trainer, step, generators = build(0)
    loader = ckpt.LoaderCheckpoint(seed=21, epoch=0, batches_consumed=0,
                                   num_epochs=num_epochs, num_trainers=1,
                                   rank=0, batch_size=batch_size)
    got = []
    it = ckpt.resume_iterator(make_ds(), loader)
    for cols, label in it:
        got.append(step(cols, label))
        if (loader.epoch, loader.batches_consumed) == (crash_epoch,
                                                       crash_after):
            break
    it.close()
    with ckpt.TrainStateCheckpointer(str(tmp_path / "ck")) as saver:
        saver.save(len(got), trainer, loader_checkpoint=loader,
                   generators=generators)
        trainer, step, generators = build(9)  # a "fresh process"
        restored = saver.restore(trainer, generators=generators)
    assert restored == loader
    for cols, label in ckpt.resume_iterator(
            make_ds(start_epoch=restored.epoch), restored):
        got.append(step(cols, label))
    return want, got, want_state, _state(trainer)


def _assert_bit_equal(want, got, want_state, got_state):
    assert len(got) == len(want)
    assert bool(torch.isfinite(torch.stack(want)).all())
    assert torch.equal(torch.stack(got), torch.stack(want))
    for name, value in want_state.items():
        assert torch.equal(value, got_state[name]), name


def test_combined_resume_matches_uninterrupted_run_sgd(tmp_path):
    files = tdg.generate_data(240, 2, str(tmp_path / "pq"))[0]
    spec = dlrm_spec()
    in_dim = len(spec["feature_columns"])

    def build(seed):
        model = mlp.MLP(in_dim, (16,), 1, compute_dtype=torch.float32,
                        device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        trainer = types.SimpleNamespace(model=model,
                                        optimizer=train.make_sgd(model))

        def step(cols, label):
            # log1p keeps the raw index features in SGD's stable range.
            x = torch.log1p(torch.cat([c.float() for c in cols], dim=1))
            return _mlp_step(trainer, x, label)

        return trainer, step, []

    _assert_bit_equal(*_resume_equals_uninterrupted(
        tmp_path, files, spec, build, batch_size=40, crash_epoch=1,
        crash_after=2))


def test_combined_resume_on_the_bulk_binding_skips_into_a_chunk(tmp_path):
    """The same resume on the bulk binding (``device_rebatch=True``, the
    default on a card): the crash falls after the first batch of epoch 1,
    whose first reducer table went to the device as one chunk of several
    batches; the resumed dataset (``start_epoch=1``) skips that batch at
    the Arrow level, before its producer enters the epoch."""
    files = tdg.generate_data(240, 2, str(tmp_path / "pq"))[0]
    spec = dlrm_spec()
    in_dim = len(spec["feature_columns"])

    def build(seed):
        model = mlp.MLP(in_dim, (16,), 1, compute_dtype=torch.float32,
                        device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        trainer = types.SimpleNamespace(model=model,
                                        optimizer=train.make_sgd(model))

        def step(cols, label):
            x = torch.log1p(torch.cat([c.float() for c in cols], dim=1))
            return _mlp_step(trainer, x, label)

        return trainer, step, []

    made = []
    _assert_bit_equal(*_resume_equals_uninterrupted(
        tmp_path, files, spec, build, batch_size=40, crash_epoch=1,
        crash_after=1, made=made, device_rebatch=True))
    uninterrupted, _, resumed = made
    chunks = uninterrupted.transfer_stats()["copies_by_epoch"][1]
    assert next(iter(chunks["chunk_batches"])) > 1
    assert resumed.binding == "bulk"
    assert resumed._scheduled_skips == {1: 1}  # the Arrow-level skip
    assert resumed.transfer_stats()["copies_by_epoch"][1]["bulk"] > 0


def test_combined_resume_matches_uninterrupted_run_bert_adam(tmp_path):
    seq_len = 32
    files = bert_mlm.generate_tokenized_parquet(
        64, 2, str(tmp_path / "tok"), seq_len=seq_len, vocab_size=1000)[0]
    config = bert.BertConfig(vocab_size=1000, hidden_dim=32, num_layers=2,
                             num_heads=4, ffn_dim=64, max_seq_len=seq_len,
                             compute_dtype=torch.float32)

    def build(seed):
        model = bert.Bert(config, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        optimizer = train.make_optimizer(model, lr=1e-3)
        mask_gen = torch.Generator().manual_seed(seed + 1)
        step = train.make_bert_micro_step(model, optimizer, mask_gen)
        return (types.SimpleNamespace(model=model, optimizer=optimizer),
                step, [mask_gen])

    _assert_bit_equal(*_resume_equals_uninterrupted(
        tmp_path, files, bert_mlm.bert_mlm_spec(seq_len), build,
        batch_size=16, crash_epoch=0, crash_after=2))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_restore_loads_onto_the_trainer_device(tmp_path):
    trainer = _mlp_trainer(0)
    with ckpt.TrainStateCheckpointer(str(tmp_path / "ck")) as saver:
        saver.save(1, trainer)
        model = mlp.MLP(4, (8,), 1, compute_dtype=torch.float32,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
        gen = torch.Generator(device="cuda").manual_seed(2)
        other = types.SimpleNamespace(model=model,
                                      optimizer=train.make_optimizer(model))
        saver.restore(other)
    for name, value in _state(trainer).items():
        got = other.model.state_dict()[name]
        assert got.is_cuda and torch.equal(got.cpu(), value), name
    assert gen.device.type == "cuda"
