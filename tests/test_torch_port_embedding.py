"""The port's embedding lookup against the JAX package's.

On the CPU the port's ``kernel`` mode runs ``gather_reference``, the plain
version of ``kernels/gather.cu``; the JAX side runs the Pallas gather in
interpret mode (``lookup(mode="pallas")``). Forward: bit-exact in f32 and
bf16, with clamping. Gradient: bit-exact for unique indices; with repeated
indices the scatter-add sums in another order, so within 1e-6 relative.

Tests marked ``cuda`` hold the CUDA kernel against its plain version on a
card and skip where there is none (run them there with
``python -m pytest -m cuda tests/test_torch_port_embedding.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.ops import embedding as jemb
from ray_shuffling_data_loader_tpu_torch.ops import embedding as temb

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
PORT_MODES = ["take", "one_hot", "kernel", "auto"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.fixture
def table_np(rng):
    return rng.standard_normal((3000, 16)).astype(np.float32)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_kernel_mode_matches_pallas_with_clamping(table_np, rng, jdt, tdt):
    idx = rng.integers(-50, 3050, 257).astype(np.int32)
    idx[:4] = [-1, 0, 2999, 3000]
    want = jemb.lookup(jnp.asarray(table_np), jnp.asarray(idx), jdt,
                       mode="pallas")
    got = temb.lookup(torch.from_numpy(table_np), torch.from_numpy(idx), tdt,
                      mode="kernel")
    assert got.dtype == tdt and got.shape == (257, 16)
    np.testing.assert_array_equal(_to_np(got), _to_np(want))


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_all_port_modes_match_jax_take(table_np, rng, mode, jdt, tdt):
    idx = rng.integers(-5, 3005, 64).astype(np.int32)
    want = jemb.take_lookup(jnp.asarray(table_np), jnp.asarray(idx), jdt)
    got = temb.lookup(torch.from_numpy(table_np), torch.from_numpy(idx), tdt,
                      mode=mode)
    np.testing.assert_array_equal(_to_np(got), _to_np(want))


@pytest.mark.parametrize("idx_dtype", [np.int8, np.int16, np.int32,
                                       np.int64])
def test_kernel_mode_takes_narrow_indices(rng, idx_dtype):
    table = rng.standard_normal((100, 8)).astype(np.float32)
    idx = rng.integers(0, 100, 33).astype(idx_dtype)
    got = temb.lookup(torch.from_numpy(table), torch.from_numpy(idx),
                      torch.float32, mode="kernel")
    np.testing.assert_array_equal(got.numpy(), table[idx])


def _grads(table_np, idx, jdt, tdt, weights):
    def jloss(t):
        out = jemb.lookup(t, jnp.asarray(idx), jdt, mode="pallas")
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(weights))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table_np)))
    t = torch.from_numpy(table_np.copy()).requires_grad_(True)
    out = temb.lookup(t, torch.from_numpy(idx), tdt, mode="kernel")
    (out.float() * torch.from_numpy(weights)).sum().backward()
    return t.grad.numpy(), want


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_gradient_bit_exact_for_unique_indices(table_np, rng, jdt, tdt):
    idx = rng.permutation(3000)[:200].astype(np.int32)
    weights = rng.standard_normal((200, 16)).astype(np.float32)
    got, want = _grads(table_np, idx, jdt, tdt, weights)
    np.testing.assert_array_equal(got, want)


def test_gradient_with_repeated_indices_within_tolerance(table_np, rng):
    # Repeats (and clamped out-of-range ids landing on row 0 / V-1) make
    # the scatter-add sum several cotangent rows in an unspecified order.
    idx = rng.integers(-20, 40, 500).astype(np.int32)
    weights = rng.standard_normal((500, 16)).astype(np.float32)
    got, want = _grads(table_np, idx, jnp.float32, torch.float32, weights)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[0]).sum() > 0 and np.abs(got[2999]).sum() == 0


def test_auto_dispatch_follows_vocab_and_device():
    small = torch.zeros((temb.ONE_HOT_MAX_VOCAB, 4))
    large = torch.zeros((temb.ONE_HOT_MAX_VOCAB + 1, 4))
    assert temb._auto_mode(small) == "one_hot"
    assert temb._auto_mode(large) == "take"  # kernel on a CUDA table
    assert temb.lookup(large, torch.tensor([0, 5]),
                       torch.float32).shape == (2, 4)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown lookup mode"):
        temb.lookup(torch.zeros((4, 2)), torch.tensor([0]), torch.float32,
                    mode="pallas")


def test_cpu_lookup_does_not_count_kernel_launches():
    temb.reset_launch_counts()
    temb.lookup(torch.zeros((5000, 4)), torch.tensor([1, 2]), torch.float32,
                mode="kernel")
    assert temb.launch_counts["gather_rows"] == 0


def test_gather_rows_refuses_cpu_tensors():
    # The kernel wrapper never runs the plain version itself: on a tensor
    # that is not on a CUDA device it raises.
    with pytest.raises(ValueError, match="CUDA device"):
        temb.gather_rows(torch.zeros((4, 4)), torch.tensor([0]),
                         torch.float32)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32,
                                       torch.int64])
def test_cuda_kernel_bit_exact_against_plain(tdt, idx_dtype):
    _cuda_or_skip()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    table = torch.randn((30000, 128), device="cuda", generator=g)
    idx = torch.randint(-100, 30100, (4099,), device="cuda",
                        generator=g).to(idx_dtype)
    temb.reset_launch_counts()
    got = temb.gather_rows(table, idx, tdt)
    torch.cuda.synchronize()
    assert temb.launch_counts["gather_rows"] == 1
    assert torch.equal(got, temb.gather_reference(table, idx, tdt))


@pytest.mark.cuda
def test_cuda_kernel_gradient_matches_plain():
    _cuda_or_skip()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    table = torch.randn((5000, 128), device="cuda", generator=g)
    idx = torch.randint(0, 5000, (2048,), device="cuda", generator=g,
                        dtype=torch.int32)
    grads = []
    # The plain version gathers in f32 and casts, so its gradient sums in
    # f32 like the kernel's (the `take` path casts first and would sum the
    # repeated rows in bf16).
    for fn in (temb.kernel_lookup, temb.gather_reference):
        t = table.clone().requires_grad_(True)
        fn(t, idx, torch.bfloat16).float().square().sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
