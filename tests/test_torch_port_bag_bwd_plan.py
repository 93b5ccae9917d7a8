"""The embedding-bag backward's host plan (``bag_bwd_plan``): its route and
workspace come from the shapes alone, its sizes are right in 64 bits at
a table past 2^31 elements, an empty batch launches nothing, and on the
CPU the backward is the plain version against the JAX package's Pallas
backward run in interpret mode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import embedding_bag as teb

jeb = importlib.import_module("analytics_zoo_tpu.ops.embedding_bag")


def _expected_lists(vocab, dim, bags, nnz, owned):
    """The lists way's sections, written out from the plan's rule."""
    slots = bags * nnz
    chunks = -(-slots // teb.BWD_CHUNK)
    cap = chunks * teb.BWD_CHUNK
    tiles = -(-(vocab + 1) // teb.BWD_SCAN_TILE)
    lead = vocab + 3 + tiles
    zeroed = 4 * (-(-lead // 4) * 4 + vocab if owned else lead)
    sizes = [zeroed, 4 * cap, 4 * min(vocab, cap // 2), 4 * cap,
             vocab + 1, 4 * cap * dim]
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-n // 256) * 256
    return chunks, zeroed, list(zip(offsets, sizes)), at


@pytest.mark.parametrize("shape,route,ops", [
    ((6041, 20, 2048, 1), "tile", 1),          # NCF slice
    ((2000, 2, 8192, 2), "tile", 1),           # WideAndDeep's wide tower
    ((37484, 100, 10240, 1), "tile", 1),       # the session gather
    ((5001, 200, 64000, 1), "lists", 6),       # the TextClassifier gather
    ((1 << 20, 64, 4096, 32), "owned", 7),     # the bench shape
    (((1 << 25) + 3, 64, 4096, 32), "lists", 6),
])
def test_plan_depends_on_the_shapes_alone(shape, route, ops):
    """The same shapes give the same plan (as ints of numpy or Python),
    with the route and device operations of that shape; the workspace
    sections are 256-byte aligned and do not overlap."""
    plan = teb.bag_bwd_plan(*shape)
    assert plan == teb.bag_bwd_plan(*(np.int64(v) for v in shape))
    assert (plan.route, plan.device_ops) == (route, ops)
    end = 0
    for _, off, nbytes in plan.sections:
        assert off % 256 == 0 and off >= end
        end = off + nbytes
    assert end <= plan.workspace_bytes
    if route == "tile":
        assert plan.workspace_bytes == plan.zeroed_bytes == 0
    else:
        chunks, zeroed, secs, total = _expected_lists(
            *shape, owned=route == "owned")
        assert plan.chunks == chunks and plan.zeroed_bytes == zeroed
        assert [s[1:] for s in plan.sections] == secs
        assert plan.workspace_bytes == total


def test_plan_sizes_past_2_31_elements():
    """At V = 2^25 + 3 and D = 64 (V * D past 2^31) the sizes are the
    64-bit values: 134,234,140 zeroed counter bytes and 33,554,432
    bytes of partials for the 131,072 slots."""
    vocab, dim = (1 << 25) + 3, 64
    plan = teb.bag_bwd_plan(vocab, dim, 4096, 32)
    assert vocab * dim > 1 << 31
    tiles = -(-(vocab + 1) // 8192)
    assert tiles == 4097
    assert plan.zeroed_bytes == 4 * (vocab + 3 + tiles) == 134234140
    sections = {name: (off, n) for name, off, n in plan.sections}
    assert sections["partials"][1] == 4 * 131072 * 64 == 33554432
    assert sections["counters"] == (0, 134234140)
    assert plan.workspace_bytes == sum(-(-n // 256) * 256
                                       for _, _, n in plan.sections)


@pytest.mark.parametrize("bags,nnz,dim", [(0, 4, 8), (5, 0, 8), (5, 4, 0)])
def test_an_empty_batch_launches_nothing(bags, nnz, dim):
    """No slot or no column: no route, no device operation, no
    workspace; with columns, the CPU backward answers zeros of (V, D)."""
    plan = teb.bag_bwd_plan(100, dim, bags, nnz)
    assert (plan.route, plan.device_ops, plan.workspace_bytes) == \
        ("none", 0, 0)
    if dim == 0:
        return
    n0 = teb.BWD_LAUNCHES.value
    out = teb.embedding_bag_backward(
        100, torch.zeros((bags, nnz), dtype=torch.int32),
        torch.ones((bags, dim)))
    assert out.shape == (100, dim) and not out.any()
    assert teb.BWD_LAUNCHES.value == n0


def test_forced_routes_and_limits():
    """A forced route is taken where the shape allows it; the tile way
    refuses more than its slots or rows wider than 32 pieces; sizes past
    2^31 - 2^8 rows or slots raise."""
    assert teb.bag_bwd_plan(6041, 20, 515, 4, "lists").route == "lists"
    assert teb.bag_bwd_plan(6041, 20, 515, 4, "owned").device_ops == 7
    with pytest.raises(ValueError, match="does not take"):
        teb.bag_bwd_plan(6041, 20, 20000, 1, "tile")
    with pytest.raises(ValueError, match="does not take"):
        teb.bag_bwd_plan(6041, 200, 100, 1, "tile")   # 50 pieces a row
    with pytest.raises(ValueError, match="does not take"):
        teb.bag_bwd_plan(6041, 20, 100, 1, "search")
    with pytest.raises(ValueError, match="fewer than"):
        teb.bag_bwd_plan(1 << 31, 8, 4, 4)
    with pytest.raises(ValueError, match="fewer than"):
        teb.bag_bwd_plan(1000, 8, 1 << 20, 1 << 11)
    with pytest.raises(ValueError, match="negative"):
        teb.bag_bwd_plan(1000, 8, -1, 4)


@pytest.mark.parametrize("combiner", teb.COMBINERS)
def test_cpu_backward_matches_the_pallas_backward(combiner):
    """On the CPU the backward is the plain version: against the JAX
    package's VJP rule (its Pallas backward in interpret mode), pad id 0,
    in-range ids (the reference's rule for out-of-range ids differs),
    duplicates within and across bags, atol 1e-6."""
    rs = np.random.RandomState(9)
    vocab, dim, bags, nnz = 13, 12, 8, 3
    ids = rs.randint(0, vocab, (bags, nnz)).astype(np.int32)
    ids[rs.rand(bags, nnz) < 0.3] = 0
    ids[0] = 0
    ids[1:4, 0] = 7
    g = rs.randn(bags, dim).astype(np.float32)
    table = np.zeros((vocab, dim), np.float32)
    want, _ = jeb._bag_bwd_rule(combiner, 0, True,
                                (jnp.asarray(table), jnp.asarray(ids)),
                                jnp.asarray(g))
    n0 = teb.BWD_LAUNCHES.value
    got = teb.embedding_bag_backward(vocab, torch.from_numpy(ids),
                                     torch.from_numpy(g), combiner, 0)
    assert teb.BWD_LAUNCHES.value == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
