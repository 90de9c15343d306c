"""Spawned gloo worlds for the port's sequence-, data- and tensor-parallel
tests.

:func:`start_world` spawns ``n`` processes that join one gloo process group
(``file://`` rendezvous in a test's own directory, so concurrent test
workers never share a port), each runs one world function of
:data:`WORLDS` on the inputs and saves what it returns; :meth:`World.join`
waits for every rank with a time limit, kills what is left, and returns
the ranks' outputs or raises with the first rank's traceback.

This module imports the port and torch only: the spawned processes load
no JAX. The world functions take numpy inputs made by the test from a
seed and return, per case, this rank's chunks of the outputs and
gradients (or the message of the error a case must raise).
"""

import multiprocessing
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist


class World:
    def __init__(self, procs, out_dir):
        self.procs, self.out_dir = procs, out_dir

    def join(self, timeout: float):
        for p in self.procs:
            p.join(timeout)
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        errors = sorted(f for f in os.listdir(self.out_dir)
                        if f.endswith(".err"))
        if errors:
            with open(os.path.join(self.out_dir, errors[0])) as f:
                raise RuntimeError(f"{errors[0]}:\n{f.read()}")
        if alive:
            raise RuntimeError(f"{len(alive)} rank(s) still running after "
                               f"{timeout} s")
        for rank, p in enumerate(self.procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {rank} exited {p.exitcode}")
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.procs))]


def start_world(n: int, name: str, inputs, out_dir: str) -> World:
    # The inputs go through a file: a start blocks until the child has
    # read its arguments from a pipe, which it does only after importing
    # torch, so large arguments would start the ranks one by one.
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, n, name, out_dir),
                         daemon=True)
             for rank in range(n)]
    for p in procs:
        p.start()
    return World(procs, out_dir)


def _rank_main(rank, n, name, out_dir):
    torch.set_num_threads(1)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        init = f"file://{os.path.join(out_dir, 'rendezvous')}"
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=n)
        try:
            out = WORLDS[name](inputs)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _t(a):
    return torch.from_numpy(np.array(a))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


# -- ring attention and Ulysses ---------------------------------------------

# case -> (strategy, causal, with bias, use_flash)
ATTENTION_CASES = {
    "ring": ("ring", False, False, None),
    "ring_causal": ("ring", True, False, None),
    "ring_bias": ("ring", False, True, None),
    "ring_causal_bias": ("ring", True, True, None),
    "ring_flash_bias": ("ring", False, True, True),
    "ulysses": ("ulysses", False, False, None),
    "ulysses_causal": ("ulysses", True, False, None),
    "ulysses_bias": ("ulysses", False, True, None),
    "ulysses_flash_bias": ("ulysses", False, True, True),
}


def _attention_case(mesh, seq_axis, batch_axis, inputs, strategy, causal,
                    with_bias, use_flash):
    """This rank's output chunk and the chunks of the gradients of
    ``sum(out ** 2)`` in q, k, v (and the bias)."""
    from ray_shuffling_data_loader_tpu_torch.ops import ring_attention as ra
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    names = ["q", "k", "v"] + (["bias"] if with_bias else [])
    leaves = {}
    for name in names:
        x = _t(inputs[name])
        seq_dim = 3 if name == "bias" else 2
        x = pmesh.batch_sharding(mesh, x, batch_axis, None)
        n = pmesh.axis_size(mesh, seq_axis)
        step = x.shape[seq_dim] // n
        x = x.narrow(seq_dim, pmesh.axis_index(mesh, seq_axis) * step, step)
        leaves[name] = x.clone().requires_grad_(True)
    fn = ra.make_attention_fn(mesh, seq_axis, strategy, batch_axis=batch_axis,
                              causal=causal, use_flash=use_flash)
    out = fn(leaves["q"], leaves["k"], leaves["v"], leaves.get("bias"))
    (out ** 2).sum().backward()
    coords = [pmesh.axis_index(mesh, a) if a else 0
              for a in (batch_axis, seq_axis)]
    return {"out": out.detach(), "coords": coords,
            **{f"d{name}": leaves[name].grad for name in names}}


def _tiny_bert(config_kw, params_np):
    from ray_shuffling_data_loader_tpu_torch import weights
    from ray_shuffling_data_loader_tpu_torch.models import bert
    config = bert.BertConfig(compute_dtype=torch.float32, **config_kw)
    model = bert.Bert(config, device="cpu")
    model.load_state_dict(weights.bert_from_jax_params(config, params_np))
    return model


def ring_world(inputs):
    from ray_shuffling_data_loader_tpu_torch.models import bert
    from ray_shuffling_data_loader_tpu_torch.ops import ring_attention as ra
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    n = dist.get_world_size()
    mesh = pmesh.named_mesh((n,), ("seq",), device="cpu")
    out = {name: _attention_case(mesh, "seq", None, inputs, *case)
           for name, case in ATTENTION_CASES.items()}
    q, k, v = (_t(inputs[x]) for x in "qkv")
    out["ring_flash_causal"] = _raises(lambda: ra.ring_self_attention(
        q, k, v, mesh, "seq", causal=True, use_flash=True))
    out["ulysses_flash_causal"] = _raises(lambda: ra.ulysses_attention(
        q, k, v, mesh, "seq", causal=True, use_flash=True))
    out["ulysses_indivisible"] = _raises(lambda: ra.ulysses_attention(
        q[:, :3], k[:, :3], v[:, :3], mesh, "seq"))
    if n == 4:
        dmesh = pmesh.named_mesh((2, 2), ("data", "seq"), device="cpu")
        out["data_seq"] = _attention_case(dmesh, "seq", "data", inputs,
                                          "ring", False, True, None)
    s = inputs["bert_ids"].shape[1] // n
    my = pmesh.axis_index(mesh, "seq")
    chunk = slice(my * s, (my + 1) * s)
    model = _tiny_bert(inputs["bert_config"], inputs["bert_params"])
    with torch.no_grad():
        for strategy in ("ring", "ulysses"):
            out[f"bert_apply_{strategy}"] = bert.apply(
                model, _t(inputs["bert_ids"][:, chunk]),
                _t(inputs["bert_mask"][:, chunk]),
                ra.make_attention_fn(mesh, "seq", strategy),
                position_offset=my * s)
    model = _tiny_bert(inputs["loss_config"], inputs["loss_params"])
    loss = bert.loss_fn(model, _t(inputs["loss_ids"][:, chunk]),
                        _t(inputs["loss_targets"][:, chunk]),
                        attention_fn=ra.make_attention_fn(mesh, "seq"),
                        position_offset=my * s, mesh=mesh)
    loss.backward()
    out["bert_loss"] = loss.detach()
    out["bert_grads"] = {name: p.grad for name, p in model.named_parameters()}
    return out


# -- the mesh, the trainer and the loader -----------------------------------


def _mesh_info(mesh, axes):
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    return {"names": tuple(mesh.mesh_dim_names),
            "sizes": [pmesh.axis_size(mesh, a) for a in axes],
            "index": [pmesh.axis_index(mesh, a) for a in axes],
            "shard_info": pmesh.local_data_shard_info(mesh)}


def _params_digest(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def dlrm_world(inputs):
    """Data parallelism on a ``("data", "model")`` mesh of (2, 1): the
    DLRM trainer's losses over the global batches, and every rank's
    parameters after them (ranks other than 0 start from other values)."""
    from ray_shuffling_data_loader_tpu_torch import train, weights
    from ray_shuffling_data_loader_tpu_torch.models import dlrm
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    out = {"dp": _mesh_info(pmesh.make_mesh(device="cpu"), ("data", "model")),
           "mp": _mesh_info(pmesh.make_mesh(2, device="cpu"),
                            ("data", "model"))}
    mesh = pmesh.make_mesh(device="cpu")
    config = dlrm.DLRMConfig(compute_dtype=torch.float32,
                             **inputs["dlrm_config"])
    model = dlrm.DLRM(config, device="cpu")
    model.load_state_dict(weights.from_jax_params(config,
                                                  inputs["dlrm_params"]))
    rank = dist.get_rank()
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(rank)
    _, data_size = pmesh.local_data_shard_info(mesh)
    trainer = ptr.SpmdTrainer(
        mesh, lambda m, sparse, labels: dlrm.loss_fn(m, None, sparse, labels)
        / data_size, model, train.make_optimizer(model, lr=1e-3))
    out["losses"] = torch.stack([
        trainer.train_step(*ptr.batch_shardings(mesh, (_t(s), _t(y))))
        for s, y in inputs["dlrm_batches"]])
    out["params"] = _params_digest(model)
    return out


def _loader_streams(mesh, files, spec, loader_kw):
    from ray_shuffling_data_loader_tpu_torch.device_dataset import (
        DeviceShufflingDataset)
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    rank, num_trainers = pmesh.local_data_shard_info(mesh)
    ds = DeviceShufflingDataset(files, num_trainers=num_trainers, rank=rank,
                                device="cpu", **loader_kw, **spec)
    streams = []
    for epoch in range(loader_kw["num_epochs"]):
        ds.set_epoch(epoch)
        streams.append([f[0] for f, _ in ds])
    return streams


def seq_world(inputs):
    """A ``("data", "seq")`` mesh of (2, 2): the JAX package's
    sequence-parallel dry run (tiny BERT, ring attention, the trainer), the
    loaders of the data ranks, and one sequence-parallel micro-step."""
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.models import bert
    from ray_shuffling_data_loader_tpu_torch.ops import ring_attention as ra
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    from ray_shuffling_data_loader_tpu_torch.workloads import bert_mlm
    mesh = pmesh.named_mesh((2, 2), ("data", "seq"), device="cpu")
    out = {"mesh": _mesh_info(mesh, ("data", "seq"))}
    model = _tiny_bert(inputs["bert_config"], inputs["bert_params"])
    attention_fn = ra.make_attention_fn(mesh, "seq", batch_axis="data")
    s = inputs["bert_tokens"][0].shape[1] // 2
    offset = pmesh.axis_index(mesh, "seq") * s

    def loss_fn(m, tokens, targets):
        return bert.loss_fn(m, tokens, targets, attention_fn=attention_fn,
                            position_offset=offset, mesh=mesh)

    trainer = ptr.SpmdTrainer(mesh, loss_fn, model,
                              train.make_optimizer(model, lr=1e-3))
    out["losses"] = torch.stack([
        trainer.train_step(*ptr.batch_shardings(
            mesh, (_t(x), _t(y)), "data", "seq"))
        for x, y in zip(inputs["bert_tokens"], inputs["bert_targets"])])
    out["params"] = _params_digest(model)

    loader = inputs["loader"]
    out["streams"] = _loader_streams(mesh, loader["files"],
                                     bert_mlm.bert_mlm_spec(loader["seq_len"]),
                                     loader["kw"])
    model = _tiny_bert(inputs["bert_config"], inputs["bert_params"])
    step = train.make_bert_spmd_micro_step(
        mesh, model, train.make_optimizer(model, lr=1e-3),
        torch.Generator().manual_seed(inputs["mask_seed"]))
    out["micro_loss"] = step([out["streams"][0][0]], None)
    return out


# -- tensor parallelism ------------------------------------------------------


def tp_model(kind, config_kw, params_np):
    """The port model of ``kind`` at the JAX package's parameters, f32."""
    from ray_shuffling_data_loader_tpu_torch import weights
    from ray_shuffling_data_loader_tpu_torch.models import (
        bert, dlrm, mlp, resnet)
    if kind == "mlp":
        model = mlp.MLP(compute_dtype=torch.float32, device="cpu",
                        **config_kw)
        model.load_state_dict({k: _t(v) for k, v in params_np.items()})
        return model
    config_cls, model_cls, load = {
        "dlrm": (dlrm.DLRMConfig, dlrm.DLRM, weights.from_jax_params),
        "bert": (bert.BertConfig, bert.Bert, weights.bert_from_jax_params),
        "resnet": (resnet.ResNetConfig, resnet.ResNet,
                   weights.resnet_from_jax_params)}[kind]
    config = config_cls(compute_dtype=torch.float32, **config_kw)
    model = model_cls(config, device="cpu")
    model.load_state_dict(load(config, params_np))
    return model


def tp_specs(kind, model):
    from ray_shuffling_data_loader_tpu_torch.models import (
        bert, dlrm, mlp, resnet)
    if kind == "mlp":
        return mlp.param_specs(model.dims)
    return {"dlrm": dlrm, "bert": bert, "resnet": resnet}[kind].param_specs(
        model.config)


def tp_loss_fn(kind, mesh):
    """This rank's term of the global loss for a batch block."""
    from ray_shuffling_data_loader_tpu_torch.models import bert, dlrm, resnet
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    _, data_size = pmesh.local_data_shard_info(mesh)
    if kind == "mlp":
        return lambda m, x, y: dlrm.bce_with_logits(m(x), y) / data_size
    if kind == "dlrm":
        return lambda m, sparse, y: dlrm.loss_fn(m, None, sparse,
                                                 y) / data_size
    if kind == "dlrm_dense":
        return lambda m, dense, sparse, y: dlrm.loss_fn(
            m, dense, sparse, y) / data_size
    if kind == "bert":
        return lambda m, tokens, targets: bert.loss_fn(m, tokens, targets,
                                                       mesh=mesh)
    return lambda m, images, labels: resnet.loss_fn(m, images,
                                                    labels) / data_size


def _tp_trainer(mesh, case, specs=True):
    from ray_shuffling_data_loader_tpu_torch import train
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    kind = case["kind"].split("_")[0]
    model = tp_model(kind, case["config"], case["params"])
    return ptr.SpmdTrainer(
        mesh, tp_loss_fn(case["kind"], mesh), model,
        train.make_optimizer(model, lr=case["lr"]),
        param_specs=tp_specs(kind, model) if specs else None)


def _tp_steps(mesh, trainer, batches):
    from ray_shuffling_data_loader_tpu_torch.parallel import trainer as ptr
    return torch.stack([
        trainer.train_step(*ptr.batch_shardings(mesh, [_t(a) for a in b]))
        for b in batches])


def _tp_case(mesh, case):
    """Losses of the case's steps, the gathered state after them and this
    rank's own parameters."""
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    trainer = _tp_trainer(mesh, case)
    losses = _tp_steps(mesh, trainer, case["batches"])
    return {"losses": losses,
            "full": tp.full_state_dict(trainer.model, trainer.param_specs,
                                       mesh),
            "local": {n: p.detach() for n, p in
                      trainer.model.named_parameters()},
            "stats": trainer.model.tp.stats.snapshot()}


def _tp_checkpoint(mesh, case, directory):
    """The JAX package's ``TestTrainStateCheckpointer`` on a sharded
    trainer: save after the steps, restore into a trainer from other
    parameters; restore into a data-parallel trainer (the global state);
    then two more steps of each, their losses and the global parameters
    after them (they read the restored Adam moments)."""
    from ray_shuffling_data_loader_tpu_torch import checkpoint as ckpt
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    trainer = _tp_trainer(mesh, case)
    _tp_steps(mesh, trainer, case["batches"])
    loader = ckpt.LoaderCheckpoint(seed=5, epoch=1, batches_consumed=3,
                                   num_epochs=4, num_trainers=1, rank=0,
                                   batch_size=8)
    out = {}
    other = _tp_trainer(mesh, dict(case, params=case["other_params"]))
    dp = _tp_trainer(mesh, case, specs=False)
    with ckpt.TrainStateCheckpointer(directory) as saver:
        out["missing"] = _raises(lambda: saver.restore(other))
        saver.save(3, trainer, loader_checkpoint=loader)
        out["latest"] = saver.latest_step()
        out["loader"] = saver.restore(other) == loader
        saver.restore(dp)
        saver.save(4, trainer)
        out["no_loader"] = saver.restore(other, step=4) is None
        saver.restore(other, step=3)
    # Copies: the next steps update the parameters in place.
    for key, t in (("saved", trainer), ("restored", other)):
        out[key] = {k: v.clone() for k, v in tp.full_state_dict(
            t.model, t.param_specs, mesh).items()}
    out["dp_restored"] = {k: v.clone()
                          for k, v in dp.model.state_dict().items()}
    out["next"] = [_tp_steps(mesh, t, case["batches"][:2])
                   for t in (trainer, other, dp)]
    out["after"] = [tp.full_state_dict(t.model, t.param_specs, mesh)
                    for t in (trainer, other)] + [dp.model.state_dict()]
    # A write that fails on rank 0 raises on every rank.
    with ckpt.TrainStateCheckpointer(f"{directory}-failing") as failing:
        if dist.get_rank() == 0:
            failing._write = _refuse_write
        try:
            failing.save(1, trainer)
            out["failed_write"] = "no error"
        except (OSError, RuntimeError) as e:
            out["failed_write"] = f"{type(e).__name__}: {e}"
        out["failed_steps"] = failing.steps()
    return out


def _refuse_write(*args):
    raise OSError("disk full")


def _tp_malformed(mesh, case):
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    model = tp_model("dlrm", case["config"], case["params"])
    specs = tp_specs("dlrm", model)
    missing = dict(specs)
    missing.pop("top.w0")
    return {
        "unknown_axis": _raises(lambda: tp.mesh_layout(
            model, {**specs, "top.w0": (None, "tensor")}, mesh)),
        "missing": _raises(lambda: tp.mesh_layout(model, missing, mesh)),
        "non_dividing": _raises(lambda: tp.mesh_layout(
            model, {**specs, "embeddings.table_2": ("model", None)}, mesh)),
        "two_dims": _raises(lambda: tp.mesh_layout(
            model, {**specs, "top.w0": ("model", "model")}, mesh))}


def _tp_qkv(mesh, case):
    """``shard_module_`` then ``full_state_dict`` on BERT, and this rank's
    QKV blocks."""
    from ray_shuffling_data_loader_tpu_torch.parallel import tp
    model = tp_model("bert", case["config"], case["params"])
    specs = tp_specs("bert", model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tp.shard_module_(model, specs, mesh)
    return {"before": before,
            "after": tp.full_state_dict(model, specs, mesh),
            "qkv_w": model.layer_0.qkv_w.detach(),
            "qkv_b": model.layer_0.qkv_b.detach()}


def _tp_keys(mesh, loader):
    from ray_shuffling_data_loader_tpu_torch.device_dataset import (
        DeviceShufflingDataset)
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    rank, num_trainers = pmesh.local_data_shard_info(mesh)
    ds = DeviceShufflingDataset(
        loader["files"], num_trainers=num_trainers, rank=rank, device="cpu",
        feature_columns=["key"], feature_types=[np.int64],
        label_column="labels", **loader["kw"])
    keys = []
    for epoch in range(loader["kw"]["num_epochs"]):
        ds.set_epoch(epoch)
        keys.append([f[0].reshape(-1) for f, _ in ds])
    return keys


def tp_world(inputs):
    """A ``("data", "model")`` mesh of ``inputs["mesh"]``: every
    tensor-parallel case, and on the mesh of two data ranks the
    checkpoint, the malformed specs, the QKV layout, the loader streams,
    ``param_specs=None`` and the dry run in this world."""
    from ray_shuffling_data_loader_tpu_torch.parallel import mesh as pmesh
    data, model_parallel = inputs["mesh"]
    mesh = pmesh.make_mesh(model_parallel, device="cpu")
    out = {"mesh": _mesh_info(mesh, ("data", "model")),
           "cases": {name: _tp_case(mesh, case)
                     for name, case in inputs["cases"].items()}}
    if data == 1:
        return out
    case = inputs["cases"]["dlrm"]
    out["dp_path"] = _tp_steps(mesh, _tp_trainer(mesh, case, specs=False),
                               case["batches"])
    out["checkpoint"] = _tp_checkpoint(mesh, inputs["checkpoint"],
                                       inputs["checkpoint"]["dir"])
    out["malformed"] = _tp_malformed(mesh, case)
    out["qkv"] = _tp_qkv(mesh, inputs["cases"]["bert"])
    out["keys"] = _tp_keys(mesh, inputs["loader"])
    from ray_shuffling_data_loader_tpu_torch.parallel import dryrun
    out["dryrun_in_process"] = dryrun.dryrun_multichip(4, device="cpu")
    return out


WORLDS = {"ring": ring_world, "dlrm": dlrm_world, "seq": seq_world,
          "tp": tp_world}
