"""Spawned gloo worlds for the port's sequence- and data-parallel tests.

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


WORLDS = {"ring": ring_world, "dlrm": dlrm_world, "seq": seq_world}
