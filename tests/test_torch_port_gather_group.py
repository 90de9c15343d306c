"""The port's grouped embedding gather (one launch for many tables).

``gather_grouped_reference`` is the plain version of the grouped CUDA
kernel in ``kernels/gather.cu``; it is held against the JAX package's
Pallas gather (``pallas_lookup``, interpret mode on the CPU) table by
table, bit for bit in f32 and bf16, with out-of-range indices and
int8/16/32/64 indices mixed in one group. ``lookup_features`` (what the
DLRM model calls) must equal per-table ``lookup`` bit for bit in every
mode. The autograd Function ``KernelGatherGroup`` runs here with the
kernel's plain version standing in for the launch: its gradients equal
the per-table ``KernelGather``'s bit for bit and the JAX package's
exactly for unique indices and within 1e-6 relative for repeated ones
(the scatter-add sums them in another order). The ``ctypes`` mirror of
the kernel's descriptor structs is held against the ``static_assert``s of
the source.

Tests marked ``cuda`` hold the kernel against its plain version on a card
and skip where there is none (run them there with
``python -m pytest -m cuda tests/test_torch_port_gather_group.py``).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu.ops import embedding as jemb
from ray_shuffling_data_loader_tpu_torch.kernels import build
from ray_shuffling_data_loader_tpu_torch.models import dlrm as tdlrm
from ray_shuffling_data_loader_tpu_torch.ops import embedding as temb

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
# (vocab, index dtype, index range): int8..int64 in one group, out-of-range
# ids on both sides where the dtype can hold them.
GROUP = [(300, np.int8, (-128, 128)), (3000, np.int16, (-50, 3050)),
         (70, np.int32, (-9, 80)), (2500, np.int64, (-3, 2503))]
BATCH, EMBED = 129, 16


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _group(rng, batch=BATCH, embed=EMBED):
    tables = [rng.standard_normal((v, embed)).astype(np.float32)
              for v, _, _ in GROUP]
    indices = []
    for _, dt, (lo, hi) in GROUP:
        idx = rng.integers(lo, hi, batch).astype(dt)
        idx[:2] = lo, hi - 1  # both ends of the range, every time
        indices.append(idx)
    return tables, indices


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_grouped_reference_matches_pallas_per_table(rng, jdt, tdt):
    tables, indices = _group(rng)
    got = temb.gather_grouped_reference(_torch(tables), _torch(indices), tdt)
    assert got.dtype == tdt and got.shape == (len(GROUP), BATCH, EMBED)
    for g, (table, idx) in enumerate(zip(tables, indices)):
        want = jemb.pallas_lookup(jnp.asarray(table), jnp.asarray(idx), jdt)
        np.testing.assert_array_equal(_to_np(got[g]), _to_np(want))
    # The CPU path of the grouped kernel lookup is the same plain version.
    assert torch.equal(temb.kernel_lookup_grouped(
        _torch(tables), _torch(indices), tdt), got)


def _mixed_model_inputs(rng):
    # Two tables at or below ONE_HOT_MAX_VOCAB, three above it.
    vocabs = [temb.ONE_HOT_MAX_VOCAB, 40, 5000, 2049, 9000]
    dts = [np.int16, np.int8, np.int32, np.int64, np.int32]
    tables = [rng.standard_normal((v, 8)).astype(np.float32) for v in vocabs]
    indices = [rng.integers(-3, min(v + 3, np.iinfo(dt).max), 64).astype(dt)
               for v, dt in zip(vocabs, dts)]
    return tables, indices


@pytest.mark.parametrize("mode", ["auto", "kernel", "take", "one_hot"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_lookup_features_equals_per_table_lookup(rng, mode, tdt):
    tables_np, indices_np = _mixed_model_inputs(rng)
    weights = rng.standard_normal((len(tables_np), 64, 8)).astype(np.float32)
    results = []
    for grouped in (True, False):
        tables = [torch.from_numpy(t.copy()).requires_grad_(True)
                  for t in tables_np]
        indices = _torch(indices_np)
        if grouped:
            vectors = temb.lookup_features(tables, indices, tdt, mode=mode)
        else:
            vectors = [temb.lookup(t, i, tdt, mode=mode)
                       for t, i in zip(tables, indices)]
        loss = sum((v.float() * torch.from_numpy(w)).sum()
                   for v, w in zip(vectors, weights))
        loss.backward()
        results.append(([v.detach() for v in vectors],
                        [t.grad for t in tables]))
    for got, want in zip(*[r[0] + r[1] for r in results]):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.fixture
def plain_launch(monkeypatch):
    """Run the kernel path on the CPU: the kernel's plain version stands in
    for its launch, so ``KernelGather``/``KernelGatherGroup`` and their
    backward run here. Counts the stand-in's calls."""
    calls = []

    def launch(tables, indices, dtype):
        calls.append(len(tables))
        return temb.gather_grouped_reference(tables, indices, dtype)

    monkeypatch.setattr(temb, "gather_rows_grouped", launch)
    monkeypatch.setattr(
        temb, "kernel_lookup_grouped",
        lambda tables, indices, dtype: temb.KernelGatherGroup.apply(
            dtype, *tables, *indices))
    return calls


def _grouped_and_single_grads(tables_np, indices_np, weights, tdt):
    grads = {}
    for how in ("grouped", "single"):
        tables = [torch.from_numpy(t.copy()).requires_grad_(True)
                  for t in tables_np]
        indices = _torch(indices_np)
        if how == "grouped":
            out = temb.KernelGatherGroup.apply(tdt, *tables, *indices)
        else:
            out = torch.stack([temb.KernelGather.apply(t, i, tdt)
                               for t, i in zip(tables, indices)])
        (out.float() * torch.from_numpy(weights)).sum().backward()
        grads[how] = [t.grad.numpy() for t in tables]
    return grads["grouped"], grads["single"]


def _jax_grads(tables_np, indices_np, weights, jdt):
    def loss(tables):
        return sum(jnp.sum(jemb.pallas_lookup(t, jnp.asarray(i), jdt)
                           .astype(jnp.float32) * jnp.asarray(w))
                   for t, i, w in zip(tables, indices_np, weights))

    return [np.asarray(g) for g in jax.grad(loss)(
        [jnp.asarray(t) for t in tables_np])]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_grouped_gradient_exact_for_unique_indices(rng, plain_launch, jdt,
                                                   tdt):
    tables_np = [rng.standard_normal((v, EMBED)).astype(np.float32)
                 for v in (300, 3000, 200)]
    indices_np = [rng.permutation(v)[:BATCH].astype(dt) for v, dt in
                  ((300, np.int16), (3000, np.int32), (200, np.int64))]
    weights = rng.standard_normal((3, BATCH, EMBED)).astype(np.float32)
    got, single = _grouped_and_single_grads(tables_np, indices_np, weights,
                                            tdt)
    want = _jax_grads(tables_np, indices_np, weights, jdt)
    for g, s, w in zip(got, single, want):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)


def test_grouped_gradient_with_repeated_indices_within_tolerance(
        rng, plain_launch):
    tables_np, indices_np = _group(rng)
    weights = rng.standard_normal(
        (len(GROUP), BATCH, EMBED)).astype(np.float32)
    got, single = _grouped_and_single_grads(tables_np, indices_np, weights,
                                            torch.float32)
    want = _jax_grads(tables_np, indices_np, weights, jnp.float32)
    for g, s, w in zip(got, single, want):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # Clamped ids land on row 0 and, where the dtype reaches past the
    # vocab, on row V-1.
    for g, (vocab, _, (_, hi)) in zip(got, GROUP):
        assert np.abs(g[0]).sum() > 0
        assert (np.abs(g[-1]).sum() > 0) == (hi > vocab)


@pytest.mark.parametrize("layout", ["array", "columns"])
def test_dlrm_kernel_path_is_one_grouped_call_and_bit_identical(
        rng, plain_launch, monkeypatch, layout):
    vocabs = (3000, 50, 7, 300, 5000)
    cfg = tdlrm.DLRMConfig(vocab_sizes=vocabs, embed_dim=8,
                           top_hidden=(16, 8), compute_dtype=torch.float32,
                           lookup_mode="kernel")
    sparse_np = np.stack([rng.integers(-3, v + 3, 32) for v in vocabs],
                         axis=1).astype(np.int32)
    labels = torch.from_numpy(rng.random((32, 1)).astype(np.float32))
    sparse = torch.from_numpy(sparse_np)
    if layout == "columns":
        sparse = [sparse[:, i:i + 1].contiguous() for i in range(len(vocabs))]
    runs = []
    for per_table in (False, True):
        model = tdlrm.DLRM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(5))
        del plain_launch[:]
        with monkeypatch.context() as m:
            if per_table:
                # The per-table kernel path the grouped call replaced.
                m.setattr(temb, "lookup_features",
                          lambda tables, indices, dtype, mode: [
                              temb.KernelGather.apply(t, i.contiguous(),
                                                      dtype)
                              for t, i in zip(tables, indices)])
            logits = model(None, sparse)
            loss = tdlrm.bce_with_logits(logits, labels)
            loss.backward()
        calls = list(plain_launch)
        runs.append((logits.detach(), loss.detach(),
                     {n: p.grad for n, p in model.named_parameters()}))
        assert calls == ([1] * len(vocabs) if per_table else [len(vocabs)])
    (logits, loss, grads), (logits1, loss1, grads1) = runs
    assert torch.equal(logits, logits1) and torch.equal(loss, loss1)
    assert grads.keys() == grads1.keys()
    for name in grads:
        assert torch.equal(grads[name], grads1[name]), name


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("unequal_embed", "one width and one batch"),
    ("unequal_batch", "one width and one batch"),
    ("strided_table", "contiguous 2-D float32"),
    ("strided_indices", "contiguous 1-D"),
    ("too_many", "1 to 32 tables"),
    ("no_tables", "1 to 32 tables"),
    ("f64_table", "contiguous 2-D float32"),
    ("f16_out", "float32 or bfloat16"),
])
def test_grouped_wrapper_raises(case, match):
    tables = [torch.zeros((10, 4)), torch.zeros((20, 4))]
    indices = [torch.zeros(6, dtype=torch.int32),
               torch.zeros(6, dtype=torch.int8)]
    dtype = torch.float32
    if case == "unequal_embed":
        tables[1] = torch.zeros((20, 8))
    elif case == "unequal_batch":
        indices[1] = torch.zeros(7, dtype=torch.int8)
    elif case == "strided_table":
        tables[1] = torch.zeros((4, 20)).t()
    elif case == "strided_indices":
        indices[0] = torch.zeros(12, dtype=torch.int32)[::2]
    elif case == "too_many":
        tables, indices = tables * 17, indices * 17
    elif case == "no_tables":
        tables, indices = [], []
    elif case == "f64_table":
        tables[0] = tables[0].double()
    elif case == "f16_out":
        dtype = torch.float16
    with pytest.raises(ValueError, match=match):
        temb.gather_rows_grouped(tables, indices, dtype)


def test_descriptor_structs_match_the_source():
    with open(build.GATHER_SOURCE) as f:
        source = f.read()
    structs = {"RsdlGatherGroup": build.GatherGroup,
               "RsdlGatherArgs": build.GatherArgs}
    found = re.findall(r"static_assert\((sizeof|offsetof)\((\w+)(?:, (\w+))?"
                       r"\) == (\d+)", source)
    assert len(found) == 12
    for what, struct, field, value in found:
        mirror = structs[struct]
        got = ctypes.sizeof(mirror) if what == "sizeof" \
            else getattr(mirror, field).offset
        assert got == int(value), (what, struct, field)
    (groups,) = re.findall(r"constexpr int kMaxGroups = (\d+);", source)
    assert int(groups) == build.GATHER_MAX_GROUPS
    assert len(build.GatherArgs().group) == build.GATHER_MAX_GROUPS


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_group(seed, batch, embed, spill=1000):
    """Five tables with int8..int64 ids, ``spill`` ids past each end of the
    vocab (as far as the dtype reaches)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    vocabs = (300, 30000, 70, 2500, 945195)
    dts = (torch.int8, torch.int16, torch.int32, torch.int64, torch.int32)
    tables = [torch.randn((v, embed), device="cuda", generator=g)
              for v in vocabs]
    indices = [torch.randint(max(-spill, torch.iinfo(dt).min),
                             min(v + spill, torch.iinfo(dt).max), (batch,),
                             device="cuda", generator=g).to(dt)
               for v, dt in zip(vocabs, dts)]
    return tables, indices


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,embed", [(2048, 128), (1001, 128), (333, 37),
                                         (64, 4)])
def test_cuda_grouped_bit_exact_with_strided_output(tdt, batch, embed):
    _cuda_or_skip()
    tables, indices = _card_group(0, batch, embed)
    want = temb.gather_grouped_reference(tables, indices, tdt)
    assert torch.equal(temb.gather_rows_grouped(tables, indices, tdt), want)
    # Straight into a (B, G, E) tensor: group g's rows are G*E apart.
    interleaved = torch.full((batch, len(tables), embed), float("nan"),
                             dtype=tdt, device="cuda")
    out = temb.gather_rows_grouped(tables, indices, tdt,
                                   out=interleaved.permute(1, 0, 2))
    torch.cuda.synchronize()
    assert out.data_ptr() == interleaved.data_ptr()
    assert torch.equal(interleaved, want.permute(1, 0, 2))


@pytest.mark.cuda
def test_cuda_one_launch_per_grouped_call():
    _cuda_or_skip()
    tables, indices = _card_group(1, 512, 128)
    temb.reset_launch_counts()
    temb.gather_rows_grouped(tables, indices, torch.bfloat16)
    assert temb.launch_counts["gather_rows"] == 1
    vectors = temb.lookup_features(tables, indices, torch.bfloat16,
                                   mode="kernel")
    assert temb.launch_counts["gather_rows"] == 2
    for v, t, i in zip(vectors, tables, indices):
        assert torch.equal(v, temb.gather_reference(t, i, torch.bfloat16))


@pytest.mark.cuda
def test_cuda_graph_replay_gives_the_same_rows():
    _cuda_or_skip()
    tables, indices = _card_group(2, 2048, 128)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        temb.gather_rows_grouped(tables, indices, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = temb.gather_rows_grouped(tables, indices, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(3):
        for t, i in zip(tables, indices):
            i.copy_(torch.randint(0, t.shape[0], i.shape, device="cuda",
                                  generator=g).clamp(max=torch.iinfo(
                                      i.dtype).max))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, temb.gather_grouped_reference(
            tables, indices, torch.bfloat16))


@pytest.mark.cuda
def test_cuda_grouped_gradient_matches_plain():
    # Ids in range: clamped ones would pile hundreds of cotangent rows onto
    # rows 0 and V-1, whose f32 sums then differ between two atomic orders
    # by more than the stated 1e-6 (the clamp is held exactly above).
    _cuda_or_skip()
    tables, indices = _card_group(4, 2048, 128, spill=0)
    weight = torch.randn((len(tables), 2048, 128), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5))
    grads = []
    for grouped in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in tables]
        out = (temb.kernel_lookup_grouped(leaves, indices, torch.bfloat16)
               if grouped else temb.gather_grouped_reference(
                   leaves, indices, torch.bfloat16))
        (out.float() * weight).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_grouped_gradient_at_clamped_ids_within_the_f32_bound():
    # spill=1000: about 1,000 cotangent rows per table pile onto rows 0 and
    # V-1, whose atomics add in no fixed order. Each row is held against
    # the f64 sum of the same cotangents within the bound of any f32
    # summation order ((m - 1) * u * sum |x|; exact where m = 1).
    _cuda_or_skip()
    tables, indices = _card_group(6, 2048, 128, spill=1000)
    weight = torch.randn((len(tables), 2048, 128), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(7))
    leaves = [t.clone().requires_grad_(True) for t in tables]
    out = temb.kernel_lookup_grouped(leaves, indices, torch.bfloat16)
    (out.float() * weight).sum().backward()
    piled = 0
    for leaf, idx, w in zip(leaves, indices, weight):
        # The cotangent of the bf16 rows is the weight rounded to bf16.
        want, bound = temb.table_grad_reference(leaf.shape[0], idx,
                                                w.to(torch.bfloat16))
        err = (leaf.grad.double() - want).abs()
        assert bool((err <= bound).all()), float((err - bound).max())
        piled = max(piled, int(torch.bincount(
            idx.long().clamp(0, leaf.shape[0] - 1)).max()))
    assert piled >= 500
