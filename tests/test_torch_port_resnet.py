"""The port's ResNet against the JAX package's ``models/resnet.py``: XLA's
``"SAME"`` padding of convolutions and the max pool, GroupNorm, and
``resnet18_cifar`` logits, loss and gradients from the same parameters
(``weights.resnet_from_jax_params``), then three SGD steps against
``optax.sgd``.

Tolerances: at f32 compute the two packages differ only in the order of
their float sums, so logits, loss and gradients agree within 1e-4
relative plus 1e-5 absolute (measured: logits 1.1e-6, gradients 5.4e-7).
At bf16 compute the two CPU convolution libraries may round their bf16
products differently, so the bound is 5e-2 relative plus 5e-2 absolute
on the logits and the loss, and a gradient's error is held within 5e-2
of that gradient's largest magnitude (measured: 3.1e-3 of it).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_shuffling_data_loader_tpu.models import resnet as jres
from ray_shuffling_data_loader_tpu_torch import train, weights
from ray_shuffling_data_loader_tpu_torch.models import resnet as tres

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_GRAD_SHARE = 5e-2


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size,kernel,stride", [
    (7, 3, 2), (8, 3, 2), (9, 7, 2), (14, 7, 2), (8, 1, 2), (7, 1, 2),
    (9, 3, 1), (10, 7, 1)])
def test_conv_same_padding_equals_lax(size, kernel, stride):
    rng = np.random.default_rng(size * 100 + kernel * 10 + stride)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres.conv_same(_nchw(x), torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))), stride)
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_same_padding_puts_the_odd_pixel_after():
    assert tres.same_padding(224, 7, 2) == (2, 3)
    assert tres.same_padding(56, 3, 2) == (0, 1)
    assert tres.same_padding(112, 3, 2) == (0, 1)
    assert tres.same_padding(57, 3, 2) == (1, 1)
    assert tres.same_padding(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [7, 8, 112 // 8, 15])
def test_max_pool_pads_with_minus_inf_as_lax(size):
    # All values negative: a zero pad would win at the edges.
    rng = np.random.default_rng(size)
    x = -1.0 - rng.random((2, size, size, 5)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = tres.max_pool_same(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 0).all()


@pytest.mark.parametrize("channels,groups,dtype", [
    (16, 8, np.float32), (12, 8, np.float32), (6, 32, np.float32),
    (32, 8, jnp.bfloat16)])
def test_group_norm_equals_jax(channels, groups, dtype):
    rng = np.random.default_rng(channels)
    x = (3.0 * rng.standard_normal((2, 5, 6, channels)) + 1.0).astype(
        np.float32)
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    want = jres._group_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                            jnp.asarray(bias), groups)
    params = tres.GroupNormParams(channels, "cpu")
    with torch.no_grad():
        params.scale.copy_(torch.from_numpy(scale))
        params.bias.copy_(torch.from_numpy(bias))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tres.group_norm(_nchw(x).to(tdtype), params, groups)
    assert got.dtype == tdtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(want, np.float32), **tol)


def _configs(compute):
    jcfg = dataclasses.replace(
        jres.resnet18_cifar(), compute_dtype=(
            jnp.float32 if compute == "f32" else jnp.bfloat16))
    tcfg = dataclasses.replace(
        tres.resnet18_cifar(), compute_dtype=(
            torch.float32 if compute == "f32" else torch.bfloat16))
    return jcfg, tcfg


def _inputs(n=4, size=16):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, (n, 1)).astype(np.int32)
    return images, labels


def _port_model(tcfg, params):
    model = tres.ResNet(tcfg, device="cpu")
    model.load_state_dict(weights.resnet_from_jax_params(
        tcfg, jax.tree.map(np.asarray, params)))
    return model


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jcfg):
    @jax.jit
    def run(params, images, labels):
        x = images.astype(jnp.float32) / 255.0
        loss, grads = jax.value_and_grad(
            lambda p: jres.loss_fn(jcfg, p, x, labels))(params)
        return jres.apply(jcfg, params, x), loss, grads

    return run


def _jax_grads(jcfg, params, images, labels):
    return _jax_grad_fn(jcfg)(params, jnp.asarray(images),
                              jnp.asarray(labels))


def _port_grads(model, images, labels):
    x = torch.from_numpy(images).float() / 255.0
    logits = tres.apply(model, x)
    loss = tres.loss_fn(model, x, torch.from_numpy(labels))
    model.zero_grad(set_to_none=True)
    loss.backward()
    return logits, loss, {k: p.grad for k, p in model.named_parameters()}


def _flat_jax(grads):
    out = {}
    for key, value in grads.items():
        if isinstance(value, dict):
            for sub, leaf in value.items():
                out[f"{key}.{sub}"] = np.asarray(leaf)
        elif np.ndim(value) == 4:
            out[key] = np.asarray(value).transpose(3, 2, 0, 1)
        else:
            out[key] = np.asarray(value)
    return out


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_resnet18_logits_loss_and_grads_equal_jax(compute):
    jcfg, tcfg = _configs(compute)
    params = jres.init(jcfg, jax.random.key(1))
    images, labels = _inputs()
    jlogits, jloss, jgrads = _jax_grads(jcfg, params, images, labels)
    model = _port_model(tcfg, params)
    logits, loss, grads = _port_grads(model, images, labels)
    tol = F32_TOL if compute == "f32" else BF16_TOL
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits), **tol)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **tol)
    want = _flat_jax(jgrads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        if compute == "f32":
            np.testing.assert_allclose(g.numpy(), want[name],
                                       err_msg=name, **F32_TOL)
        else:
            err = np.abs(g.numpy() - want[name]).max()
            assert err <= BF16_GRAD_SHARE * np.abs(want[name]).max() + 1e-6, (
                name, err)


def test_remat_gives_the_same_gradients():
    _, tcfg = _configs("f32")
    images, labels = _inputs()
    plain = tres.ResNet(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    remat = tres.ResNet(dataclasses.replace(tcfg, remat=True), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    _, loss_a, grads_a = _port_grads(plain, images, labels)
    _, loss_b, grads_b = _port_grads(remat, images, labels)
    assert float(loss_a.detach()) == float(loss_b.detach())
    for name in grads_a:
        torch.testing.assert_close(grads_a[name], grads_b[name], rtol=0,
                                   atol=0, msg=name)


def test_three_sgd_steps_equal_optax():
    jcfg, tcfg = _configs("f32")
    params = jres.init(jcfg, jax.random.key(2))
    model = _port_model(tcfg, params)
    step = train.make_resnet_micro_step(model, train.make_sgd(model))
    opt = optax.sgd(1e-2)
    opt_state = opt.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        images = rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)
        labels = rng.integers(0, 10, (4, 1)).astype(np.int32)
        _, jloss, grads = _jax_grads(jcfg, params, images, labels)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        loss = step([torch.from_numpy(images)], torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), **F32_TOL)
    want = _flat_jax(params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_resnet50_parameter_count_equals_jax():
    shapes = jax.eval_shape(lambda: jres.init(jres.resnet50(),
                                              jax.random.key(0)))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree.leaves(shapes))
    model = tres.ResNet(tres.resnet50(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want == 25_557_032
    assert set(model.state_dict()) == set(_flat_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)))


def test_resnet_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.ResNet(tres.resnet18_cifar())


def test_weights_reject_a_misshapen_kernel():
    jcfg, tcfg = _configs("f32")
    params = jax.tree.map(np.asarray, jres.init(jcfg, jax.random.key(0)))
    params["stem_conv"] = params["stem_conv"][:, :, :, :3]
    with pytest.raises(ValueError, match="stem_conv"):
        weights.resnet_from_jax_params(tcfg, params)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_resnet18_step_matches_the_cpu_step():
    jcfg, tcfg = _configs("f32")
    params = jres.init(jcfg, jax.random.key(3))
    images, labels = _inputs()
    cpu_model = _port_model(tcfg, params)
    gpu_model = tres.ResNet(tcfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    _, cpu_loss, _ = _port_grads(cpu_model, images, labels)
    x = torch.from_numpy(images).cuda().float() / 255.0
    gpu_loss = tres.loss_fn(gpu_model, x, torch.from_numpy(labels).cuda())
    np.testing.assert_allclose(float(gpu_loss.detach()),
                               float(cpu_loss.detach()), rtol=1e-3)
