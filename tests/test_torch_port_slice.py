"""The port's DLRM train path as a whole against the JAX package's.

Both packages shuffle the same Parquet files with the same seed; each
trains the same initial DLRM parameters with Adam for 5 micro-steps on its
own first batch. The batches must be equal, and the loss trajectories agree
within 1e-5 relative: ``torch.optim.Adam`` and ``optax.adam`` compute
``m_hat / (sqrt(v_hat) + eps)`` with the same constants but round in a
different order, and the forward sums matmuls in a different order.

Also pinned here: importing every module of the port loads neither
``jax`` nor the JAX package.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu import data_generation as jdg
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.models import dlrm as jdlrm
from ray_shuffling_data_loader_tpu.workloads import dlrm_criteo as jwl
from ray_shuffling_data_loader_tpu_torch import train, weights
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset)
from ray_shuffling_data_loader_tpu_torch.models import dlrm as tdlrm
from ray_shuffling_data_loader_tpu_torch.workloads import dlrm_criteo as twl

from torch_port_fixtures import thread_backend  # noqa: F401 (autouse)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1000
MICRO = 200
# Every table of the reference schema, cardinalities capped so the CPU
# run stays small; 8 of them stay above ONE_HOT_MAX_VOCAB (gather path).
VOCABS = tuple(min(v, 3000) for v in jdlrm.DATA_SPEC_VOCAB_SIZES)


def _first_batches(files, queue_name):
    jds = JaxShufflingDataset(files, 1, 1, BATCH, 0, num_reducers=3, seed=11,
                              num_workers=1, device_rebatch=False,
                              queue_name=queue_name,
                              **jwl.dlrm_spec())
    jds.set_epoch(0)
    jfeatures, jlabel = next(iter(jds))
    jds.close()
    tds = DeviceShufflingDataset(files, 1, 1, BATCH, 0, num_reducers=3,
                                 seed=11, device="cpu", **twl.dlrm_spec())
    tds.set_epoch(0)
    batches = list(tds)
    return (jfeatures, jlabel), batches[0]


@pytest.mark.parametrize("lookup", [("pallas", "kernel"), ("auto", "auto")])
def test_five_adam_micro_steps_match_optax(tmp_path, lookup):
    files, _ = jdg.generate_data_local(4000, 2, 1, 0.0, str(tmp_path))
    (jfeatures, jlabel), (tfeatures, tlabel) = _first_batches(
        files, f"torch-port-slice-{lookup[1]}")
    for a, b in zip(jfeatures, tfeatures):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jlabel), tlabel.numpy())

    jcfg = jdlrm.DLRMConfig(vocab_sizes=VOCABS, embed_dim=8,
                            top_hidden=(16, 8), compute_dtype=jnp.float32,
                            lookup_mode=lookup[0])
    tcfg = tdlrm.DLRMConfig(vocab_sizes=VOCABS, embed_dim=8,
                            top_hidden=(16, 8), compute_dtype=torch.float32,
                            lookup_mode=lookup[1])
    params = jdlrm.init(jcfg, jax.random.key(2))
    model = tdlrm.DLRM(tcfg, device="cpu")
    model.load_state_dict(weights.from_jax_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params)))

    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def jstep(params, opt_state, cols, labels):
        loss, grads = jax.value_and_grad(
            lambda p: jdlrm.loss_fn(jcfg, p, None, cols, labels))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    want = []
    for lo in range(0, BATCH, MICRO):
        cols = [jnp.asarray(f)[lo:lo + MICRO] for f in jfeatures]
        params, opt_state, loss = jstep(params, opt_state, cols,
                                        jnp.asarray(jlabel)[lo:lo + MICRO])
        want.append(float(loss))

    step = train.make_micro_step(model, train.make_optimizer(model))
    got = train.train_chunk(step, tfeatures, tlabel, MICRO)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for name, p in model.named_parameters():
        group, key = name.split(".")
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(params[group][key]), rtol=1e-4,
            atol=1e-6, err_msg=name)


def test_train_chunk_rejects_non_dividing_microbatch():
    with pytest.raises(ValueError, match="must divide"):
        train.train_chunk(lambda c, y: y.sum(), [torch.zeros(10, 1)],
                          torch.zeros(10, 1), 3)


def test_optimizer_is_optax_adam_defaults():
    model = torch.nn.Linear(2, 2)
    group = train.make_optimizer(model).param_groups[0]
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_shuffling_data_loader_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, "
        "port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ray_shuffling_data_loader_tpu' "
        "or m.startswith('ray_shuffling_data_loader_tpu.'))\n"
        "assert len(names) >= 15, names\n"
        "for name in ('multiqueue_service', 'runtime.supervisor', "
        "'streaming.source', 'streaming.window', 'streaming.runner', "
        "'tenancy', 'tenancy.fairshare', 'tenancy.admission', "
        "'runtime.history', 'runtime.health', 'runtime.profiler', "
        "'torch_dataset', 'analysis.core', 'analysis.cli', "
        "'analysis.rules_torch'):\n"
        "    assert port.__name__ + '.' + name in names, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
