"""The port's tensor parallelism (``parallel/tp.py``, the models'
``param_specs``, ``SpmdTrainer(param_specs=)``, the checkpointer and the
dry run) against the JAX package's ``SpmdTrainer`` with ``param_specs``.

The port side runs in two spawned gloo worlds (``torch_port_world``),
each once for the whole file: ``("data", "model")`` meshes of (1, 2) and
(2, 2). Each trains every case three Adam steps (lr 1e-3, f32 compute)
from the JAX package's initial parameters on global batches made with
numpy seed 0; the (2, 2) world also runs the checkpoint round trips, the
malformed specs, the QKV layout, the loader streams and the trainer
without specs. The JAX side is ``SpmdTrainer`` on ``make_mesh(d * m,
model_parallel=m)`` of the conftest's 8-device CPU platform, with the same
parameters, specs and batches.

Tolerances: the losses within 1e-5 relative (1e-4 for BERT, the ring
test's; ``torch.optim.Adam`` and ``optax.adam`` round in another order, and
the row-parallel sums add their parts in another order). The gathered
parameters are held by their change over the steps against the JAX
trainer's change from the same start: per parameter, the norm of the
difference of the two changes within 1e-2 of the norm of JAX's change
(the most seen is 1.4e-3, ResNet's ``s1b0_conv2``), and each element
within 1e-4 relative plus ``LR`` absolute (an element whose gradient
changes sign between steps is divided by a small second moment, so the
last bits of its gradients move it by a part of ``LR``: 0.24 ``LR`` at
most seen). Replicated parameters are equal bit for bit across every
rank, sharded ones across the data peers; the checkpoint round trip is
bit for bit, parameters and Adam moments (the two next steps' losses and
parameters), and the data-parallel trainer restored from it takes the
same two steps within the tolerances above; the loader streams exact.
"""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_port_world as world
from ray_shuffling_data_loader_tpu.models import bert as jbert
from ray_shuffling_data_loader_tpu.models import dlrm as jdlrm
from ray_shuffling_data_loader_tpu.models import mlp as jmlp
from ray_shuffling_data_loader_tpu.models import resnet as jresnet
from ray_shuffling_data_loader_tpu.parallel import mesh as jmesh
from ray_shuffling_data_loader_tpu.parallel import trainer as jtrainer
from ray_shuffling_data_loader_tpu_torch import data_generation as tdg
from ray_shuffling_data_loader_tpu_torch import weights
from ray_shuffling_data_loader_tpu_torch.models import bert as tbert
from ray_shuffling_data_loader_tpu_torch.models import dlrm as tdlrm
from ray_shuffling_data_loader_tpu_torch.models import mlp as tmlp
from ray_shuffling_data_loader_tpu_torch.models import resnet as tresnet
from ray_shuffling_data_loader_tpu_torch.parallel import dryrun
from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
from ray_shuffling_data_loader_tpu_torch.parallel import tp

from torch_port_fixtures import one_rank_world  # noqa: F401 (fixture)
from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)

LOSS_RTOL, BERT_RTOL, PARAM_RTOL, CHANGE_RTOL = 1e-5, 1e-4, 1e-4, 1e-2
LR, STEPS = 1e-3, 3
PARAM_ATOL = LR
JOIN_TIMEOUT_S, DRYRUN_TIMEOUT_S = 240, 120
MESHES = {"tp12": (1, 2), "tp22": (2, 2)}
BATCH = 8
# kind, JAX config, port config (the JAX config's fields the port takes).
DLRM = dict(vocab_sizes=(3000, 50, 7, 300), embed_dim=8, top_hidden=(16, 8),
            lookup_mode="auto")
CASES = {
    # Two layers: the column-parallel layer's split output is gathered
    # before the replicated last layer.
    "mlp_even": ("mlp", dict(in_dim=6, hidden_dims=(16,), out_dim=1)),
    "mlp_odd": ("mlp", dict(in_dim=6, hidden_dims=(16, 8), out_dim=1)),
    "dlrm": ("dlrm", DLRM),
    "dlrm_dense": ("dlrm_dense", dict(DLRM, dense_dim=4,
                                      bottom_hidden=(8,))),
    "bert": ("bert", dict(vocab_size=1000, hidden_dim=64, num_layers=2,
                          num_heads=4, ffn_dim=128, max_seq_len=64)),
    "resnet": ("resnet", dict(stage_sizes=(1, 1), width=16, num_classes=10,
                              num_groups=8)),
}
SEQ, IMAGE = 16, 16
CHECKPOINT = dict(vocab_sizes=(32, 16), embed_dim=8, top_hidden=(16,))
LOADER_ROWS = 120
LOADER = {"files": None, "kw": dict(num_epochs=2, batch_size=16,
                                    drop_last=False, num_reducers=3, seed=3)}
JAX_MODULES = {"mlp": jmlp, "dlrm": jdlrm, "bert": jbert,
               "resnet": jresnet}
JAX_CONFIGS = {"mlp": jmlp.MLPConfig, "dlrm": jdlrm.DLRMConfig,
               "bert": jbert.BertConfig, "resnet": jresnet.ResNetConfig}


def _base(kind):
    return kind.split("_")[0]


def _jax_config(kind, config):
    return JAX_CONFIGS[_base(kind)](compute_dtype=jnp.float32, **config)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(kind, config_kw, device="meta"):
    """The port model of ``kind``, f32, its parameters on ``device``."""
    if _base(kind) == "mlp":
        return tmlp.MLP(device=device, compute_dtype=torch.float32,
                        **config_kw)
    config_cls, model_cls = {
        "dlrm": (tdlrm.DLRMConfig, tdlrm.DLRM),
        "bert": (tbert.BertConfig, tbert.Bert),
        "resnet": (tresnet.ResNetConfig, tresnet.ResNet)}[_base(kind)]
    return model_cls(config_cls(compute_dtype=torch.float32, **config_kw),
                     device=device)


def _jax_tree(state):
    """A port state dict as the JAX package's parameter tree: names split
    on ".", conv kernels OIHW -> HWIO."""
    tree = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        a = t.detach().numpy()
        node[leaf] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return tree


def _initial_params(kind, config, seed):
    """Initial parameters from the port's initialisers (seeded), in the
    JAX package's tree: both sides start from them."""
    torch.manual_seed(seed)
    return _jax_tree(_port_model(kind, config, "cpu").state_dict())


def _batches(kind, config, rng):
    out = []
    for _ in range(STEPS):
        if _base(kind) == "mlp":
            batch = (rng.normal(size=(BATCH, config["in_dim"])),
                     rng.random((BATCH, 1)) < 0.5)
            batch = tuple(a.astype(np.float32) for a in batch)
        elif _base(kind) == "dlrm":
            sparse = np.stack([rng.integers(-3, v + 3, BATCH)
                               for v in config["vocab_sizes"]],
                              axis=1).astype(np.int32)
            labels = rng.random((BATCH, 1)).astype(np.float32)
            batch = (sparse, labels)
            if kind == "dlrm_dense":
                batch = (rng.normal(size=(BATCH, config["dense_dim"]))
                         .astype(np.float32),) + batch
        elif kind == "bert":
            tokens = rng.integers(0, config["vocab_size"], (BATCH, SEQ))
            targets = np.where(rng.random(tokens.shape) < 0.15, tokens,
                               jbert.IGNORE_ID)
            batch = (tokens.astype(np.int32), targets.astype(np.int32))
        else:
            batch = (rng.random((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                     rng.integers(0, config["num_classes"], BATCH)
                     .astype(np.int32))
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {}
    for i, (name, (kind, config)) in enumerate(CASES.items()):
        params = _initial_params(kind, config, i)
        cases[name] = {"kind": kind, "config": config, "lr": LR,
                       "params": params,
                       "batches": _batches(kind, config, rng)}
    ckpt_config = dict(CHECKPOINT, lookup_mode="auto")
    checkpoint = {"kind": "dlrm", "config": ckpt_config, "lr": LR,
                  "params": _initial_params("dlrm", ckpt_config, 0),
                  "other_params": _initial_params("dlrm", ckpt_config, 99),
                  "batches": _batches("dlrm", ckpt_config, rng)}
    files, _ = tdg.generate_data(LOADER_ROWS, 3, str(
        tmp_path_factory.mktemp("tp_loader")), seed=0)
    return {"cases": cases, "checkpoint": checkpoint,
            "loader": {**LOADER, "files": files}}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory, dryruns):
    """Both port worlds ({"tp12": 2 ranks' outputs, "tp22": 4 ranks'}),
    started together (after the dry runs' processes: ``dryruns``), and
    the JAX side, run here meanwhile: per mesh and
    case the JAX trainer's losses and final parameters in the port's
    names, and (``"dp"``) the data-parallel trainer on the (2, 2) mesh."""
    worlds = {}
    for name, mesh in MESHES.items():
        directory = str(tmp_path_factory.mktemp(name))
        sent = {**inputs, "mesh": mesh,
                "checkpoint": {**inputs["checkpoint"],
                               "dir": f"{directory}/ck"}}
        worlds[name] = world.start_world(mesh[0] * mesh[1], "tp", sent,
                                         directory)
    meshes = {name: jmesh.make_mesh(num_devices=d * m, model_parallel=m)
              for name, (d, m) in MESHES.items()}
    # XLA compiles without the interpreter lock: the cases in parallel.
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        futures = {mesh_name: {name: pool.submit(_jax_run, mesh, case)
                               for name, case in inputs["cases"].items()}
                   for mesh_name, mesh in meshes.items()}
        dp = pool.submit(_jax_run, meshes["tp22"], inputs["cases"]["dlrm"],
                         specs=False)
        jax_out = {mesh_name: {name: f.result() for name, f in fs.items()}
                   for mesh_name, fs in futures.items()}
        jax_out["dp"] = dp.result()
    return {"ranks": {name: w.join(JOIN_TIMEOUT_S)
                      for name, w in worlds.items()}, "jax": jax_out}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


def _jax_loss(kind, config):
    module = JAX_MODULES[_base(kind)]
    if kind == "dlrm":
        return lambda p, sparse, y: module.loss_fn(config, p, None, sparse, y)
    return lambda p, *batch: module.loss_fn(config, p, *batch)


def _jax_run(mesh, case, specs=True):
    kind = case["kind"]
    config = _jax_config(kind, case["config"])
    module = JAX_MODULES[_base(kind)]
    trainer = jtrainer.SpmdTrainer(
        mesh, _jax_loss(kind, config), jax.tree_util.tree_map(
            jnp.asarray, case["params"]), optax.adam(case["lr"]),
        param_specs=module.param_specs(config) if specs else None)
    losses = []
    for batch in case["batches"]:
        placed = [jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, P("data", *([None] * (a.ndim - 1))))) for a in batch]
        losses.append(float(trainer.train_step(*placed)))
    return np.asarray(losses), _port_state(kind, case["config"],
                                            _np_tree(trainer.params))


def _port_state(kind, config_kw, params_np):
    base = _base(kind)
    if base == "mlp":
        return {k: torch.from_numpy(np.array(v)) for k, v in
                params_np.items()}
    config = {"dlrm": tdlrm.DLRMConfig, "bert": tbert.BertConfig,
              "resnet": tresnet.ResNetConfig}[base](
                  compute_dtype=torch.float32, **config_kw)
    load = {"dlrm": weights.from_jax_params,
            "bert": weights.bert_from_jax_params,
            "resnet": weights.resnet_from_jax_params}[base]
    return load(config, params_np)


# -- spec trees -------------------------------------------------------------


def _flat_jax_specs(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat_jax_specs(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tuple(value)


@pytest.mark.parametrize("name", ["mlp_even", "mlp_odd", "dlrm",
                                  "dlrm_dense", "bert", "resnet"])
def test_param_specs_match_the_jax_spec_trees(name):
    """Each port spec has the port model's parameter names, and the JAX
    spec's entries at the same flattened path (a ResNet conv's permuted
    from HWIO to the port's OIHW)."""
    kind, config = CASES[name]
    model = _port_model(kind, config)
    specs = world.tp_specs(_base(kind), model)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    jax_config = _jax_config(kind, config)
    want = dict(_flat_jax_specs(
        JAX_MODULES[_base(kind)].param_specs(jax_config)))
    assert set(want) == set(specs)
    for key, spec in specs.items():
        expected = want[key]
        if len(expected) == 4:
            expected = tuple(expected[i] for i in (3, 2, 0, 1))
        assert spec == expected, key


def test_param_specs_of_the_full_width_models():
    """``bert_base``, ResNet-50 and DLRM ``mlperf`` split at two ranks."""
    for model_cls, config, specs in (
            (tbert.Bert, tbert.bert_base(), tbert.param_specs),
            (tresnet.ResNet, tresnet.resnet50(), tresnet.param_specs),
            (tdlrm.DLRM, tdlrm.MLPERF, tdlrm.param_specs)):
        model = model_cls(config, device="meta")
        layout = tp.param_layout(model, specs(config), ("data", "model"),
                                 (1, 2))
        assert any(d is not None for d in layout.values())


# -- the step against JAX ---------------------------------------------------


def assert_change_matches(got, want, start, key):
    """``got`` and ``want`` both moved from ``start``: their changes agree
    per parameter (norm) and per element (see the module docstring)."""
    got, want, start = (t.double().numpy() for t in (got, want, start))
    change = want - start
    err = np.linalg.norm((got - start) - change)
    assert err <= CHANGE_RTOL * np.linalg.norm(change), (
        f"{key}: the change differs from JAX's by {err}, JAX's change has "
        f"norm {np.linalg.norm(change)}")
    np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=key)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_steps_match_jax(inputs, ranks, jax_runs, mesh_name,
                                         name):
    want_losses, want_params = jax_runs[mesh_name][name]
    case = inputs["cases"][name]
    start = _port_state(case["kind"], case["config"], case["params"])
    rtol = BERT_RTOL if name == "bert" else LOSS_RTOL
    for out in ranks[mesh_name]:
        got = out["cases"][name]
        np.testing.assert_allclose(got["losses"].numpy(), want_losses,
                                   rtol=rtol)
        assert set(got["full"]) == set(want_params)
        for key, want in want_params.items():
            assert_change_matches(got["full"][key], want, start[key], key)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_replicated_parameters_are_one_value(ranks, mesh_name, name):
    """Replicated parameters are bit-identical on every rank, sharded ones
    on the ranks that share a model coordinate; the sharded ones hold the
    blocks of the gathered state."""
    outs = ranks[mesh_name]
    kind, config = CASES[name]
    specs = world.tp_specs(_base(kind), _port_model(kind, config))
    model_size = MESHES[mesh_name][1]
    for rank, out in enumerate(outs):
        local = out["cases"][name]["local"]
        full = out["cases"][name]["full"]
        for key, spec in specs.items():
            dim = tp.spec_dim(spec)
            peer = outs[rank % model_size]["cases"][name]["local"][key]
            assert torch.equal(local[key], peer), key
            if dim is None:
                assert torch.equal(local[key], outs[0]["cases"][name][
                    "local"][key]), key
                assert torch.equal(local[key], full[key]), key
            else:
                assert local[key].shape[dim] * model_size == \
                    full[key].shape[dim]


def test_model_axis_collectives_are_counted(ranks):
    """DLRM at TP=2: the Gram partials' all-reduce and the gathered mean
    embedding every step, payload bytes by operator."""
    for out in ranks["tp12"]:
        stats = out["cases"]["dlrm"]["stats"]
        assert stats["calls"]["reduce_from_model"] >= 2 * STEPS
        assert stats["calls"]["gather_from_model"] >= STEPS
        f = len(DLRM["vocab_sizes"])
        assert stats["bytes"]["gather_from_model"] >= (
            STEPS * BATCH * DLRM["embed_dim"] * 4)
        assert stats["bytes"]["reduce_from_model"] >= STEPS * BATCH * f * f * 4


# -- the (2, 2) world's other cases -----------------------------------------


def test_param_specs_none_is_the_data_parallel_path(ranks, jax_runs):
    """Without specs on a (2, 2) mesh the model peers read one batch and
    the gradients sum over the data axis only: the JAX data-parallel
    trainer's losses."""
    want, _ = jax_runs["dp"]
    for out in ranks["tp22"]:
        np.testing.assert_allclose(out["dp_path"].numpy(), want,
                                   rtol=LOSS_RTOL)
        assert torch.equal(out["dp_path"], ranks["tp22"][0]["dp_path"])


def test_checkpoint_round_trip_is_exact_and_restores_into_dp(ranks):
    """The JAX ``TestTrainStateCheckpointer`` on a (2, 2) mesh at TP=2:
    the restored trainer holds the saved global state, and its next two
    steps (which read the restored Adam moments) give the same losses and
    parameters bit for bit; the saved state restored into a trainer
    without specs is the global state, and its two steps agree."""
    for out in ranks["tp22"]:
        ck = out["checkpoint"]
        assert ck["missing"].startswith("ValueError: no checkpoint")
        assert ck["latest"] == 3 and ck["loader"] and ck["no_loader"]
        for key, want in ck["saved"].items():
            assert torch.equal(ck["restored"][key], want), key
            assert torch.equal(ck["dp_restored"][key], want), key
        tp_next, other_next, dp_next = ck["next"]
        assert torch.equal(tp_next, other_next)
        np.testing.assert_allclose(dp_next.numpy(), tp_next.numpy(),
                                   rtol=LOSS_RTOL)
        tp_after, other_after, dp_after = ck["after"]
        assert set(tp_after) == set(other_after) == set(dp_after)
        for key, want in tp_after.items():
            assert torch.equal(other_after[key], want), key
            assert_change_matches(dp_after[key], want, ck["saved"][key], key)


def test_a_failed_checkpoint_write_raises_on_every_rank(ranks):
    """Rank 0's write fails: it raises there, and every other rank raises
    with rank 0's error instead of going on as if the step were saved."""
    for rank, out in enumerate(ranks["tp22"]):
        ck = out["checkpoint"]
        want = ("OSError: disk full" if rank == 0 else
                "RuntimeError: rank 0 could not save step 1: OSError: "
                "disk full")
        assert ck["failed_write"] == want
        assert ck["failed_steps"] == []


@pytest.mark.parametrize("case,message", [
    ("unknown_axis", "names axis 'tensor'"),
    ("missing", "missing ['top.w0']"),
    ("non_dividing", "does not split into 2 blocks"),
    ("two_dims", "more than one dimension"),
])
def test_malformed_specs_raise(ranks, case, message):
    for out in ranks["tp22"]:
        got = out["malformed"][case]
        assert got.startswith("ValueError") and message in got, got


def test_qkv_is_sharded_by_head(inputs, ranks):
    """``shard_module_`` then ``full_state_dict`` is the identity bit for
    bit, and rank r holds heads ``[r nh/2, (r+1) nh/2)`` of each of q, k
    and v (JAX: ``qkv_w`` is ``(H, 3H)``, q|k|v side by side)."""
    h = CASES["bert"][1]["hidden_dim"]
    for rank, out in enumerate(ranks["tp22"]):
        qkv = out["qkv"]
        assert set(qkv["after"]) == set(qkv["before"])
        for key, want in qkv["before"].items():
            assert torch.equal(qkv["after"][key], want), key
        model_rank = rank % 2
        cols = np.concatenate([np.arange(j * h + model_rank * h // 2,
                                         j * h + (model_rank + 1) * h // 2)
                               for j in range(3)])
        w = qkv["before"]["layer_0.qkv_w"]
        assert torch.equal(qkv["qkv_w"], w[:, cols])
        assert torch.equal(qkv["qkv_b"],
                           qkv["before"]["layer_0.qkv_b"][cols])


def test_model_peers_read_one_stream(ranks):
    """Model peers get identical batches; over the data axis every key
    appears once per epoch."""
    outs = ranks["tp22"]
    for epoch in range(LOADER["kw"]["num_epochs"]):
        keys = []
        for data_rank in range(2):
            a, b = (outs[2 * data_rank + m]["keys"][epoch] for m in (0, 1))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            keys.append(torch.cat(a))
        assert sorted(torch.cat(keys).tolist()) == list(range(LOADER_ROWS))


def test_mesh_axes_of_the_tp_worlds(ranks):
    for name, (data, model) in MESHES.items():
        for rank, out in enumerate(ranks[name]):
            info = out["mesh"]
            assert info["sizes"] == [data, model]
            assert info["index"] == [rank // model, rank % model]
            assert info["shard_info"] == (rank // model, data)


# -- in this process --------------------------------------------------------


def test_batch_group_is_the_default_group_without_a_model_axis(
        one_rank_world):
    assert pmesh.batch_group(one_rank_world) is None
    assert pmesh.axis_size(one_rank_world, "model") == 1


def test_specs_that_shard_nothing_leave_the_model_replicated(
        one_rank_world):
    model = tmlp.MLP(3, (4,), 1, device="cpu")
    specs = {name: (None,) * p.ndim for name, p in model.named_parameters()}
    assert tp.shard_module_(model, specs, one_rank_world) == {}
    assert model.tp is None


@pytest.fixture(scope="module")
def dryruns():
    """Both dry runs start at once (each ``n`` processes)."""
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        yield {n: pool.submit(dryrun.dryrun_multichip, n, device="cpu",
                              timeout_s=DRYRUN_TIMEOUT_S) for n in (2, 4)}


@pytest.mark.parametrize("n,mesh", [(2, [1, 2]), (4, [2, 2])])
def test_dryrun_multichip(dryruns, n, mesh):
    out = dryruns[n].result(timeout=DRYRUN_TIMEOUT_S + 30)
    assert len(out) == n
    for rank, summary in enumerate(out):
        assert summary["rank"] == rank and summary["mesh"] == mesh
        assert np.isfinite(summary["loss"])
        assert len(summary["loader_losses"]) == dryrun.LOADER_STEPS
        assert summary["binding"] == "bulk"
    # The model peers of a data rank compute the same global loss.
    assert len({s["loss"] for s in out}) == 1


def test_dryrun_multichip_in_a_world_of_its_size(ranks, dryruns):
    """Called by every rank of a world of 4, the dry run runs there (no
    processes) and trains as the spawned one does."""
    spawned = dryruns[4].result(timeout=DRYRUN_TIMEOUT_S + 30)
    for rank, out in enumerate(ranks["tp22"]):
        (summary,) = out["dryrun_in_process"]
        assert summary["rank"] == rank and summary["mesh"] == [2, 2]
        assert summary["loss"] == spawned[rank]["loss"]
        assert summary["loader_losses"] == spawned[rank]["loader_losses"]
