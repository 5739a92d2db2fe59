"""The port's mesh, sharding specs and halo exchange (parallel/mesh.py,
parallel/halo.py) against the JAX package's on the CPU.

The port's slots are `torch.device("cpu")` listed several times; the JAX
side runs on conftest's 8 virtual CPU devices. Ghost rows must be the JAX
exchange's exactly, stencil outputs agree to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from image_segmenter_tpu.parallel import halo as JH
from image_segmenter_tpu.parallel import mesh as JM
from image_segmenter_tpu_torch.parallel import halo as TH
from image_segmenter_tpu_torch.parallel import mesh as TM

try:  # jax >= 0.7
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _slots(n):
    return [CPU] * n


@pytest.mark.parametrize("shape,n", [((2, 2), 4), ((1, 8), 8), ((4, 1), 6),
                                     (None, 3)])
def test_make_mesh_shapes(shape, n):
    mesh = TM.make_mesh(shape, devices=_slots(n))
    want = (n, 1) if shape is None else shape
    assert mesh.shape == want and mesh.axis_names == ("data", "space")
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh.first == CPU
    assert mesh.group(1 if want[0] > 1 else 0).shape == (1, want[1])
    # the JAX package's mesh of the same shape over its devices
    jmesh = JM.make_mesh(want, devices=jax.devices()[:int(np.prod(want))])
    assert jmesh.devices.shape == mesh.shape


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        TM.make_mesh((2, 4), devices=_slots(4))
    with pytest.raises(ValueError, match="needs 8 devices"):
        JM.make_mesh((2, 4), devices=jax.devices()[:4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh((1, 1))


@pytest.mark.parametrize("n,k", [(8, 4), (10, 4), (3, 5), (7, 1), (0, 2)])
def test_split_bounds_are_tensor_split(n, k):
    x = torch.arange(n)
    got = [x[a:b] for a, b in TM.split_bounds(n, k)]
    want = torch.tensor_split(x, k)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mesh_shape,x_shape", [
    ((2, 2), (4, 6, 5, 3)),
    ((2, 2), (3, 7, 5, 3)),     # uneven on both split axes
    ((3, 2), (5, 9, 4, 3)),
    ((1, 8), (2, 64, 3, 3)),
    ((2, 2), (5, 7, 3)),        # fewer dimensions than the spec
])
def test_batch_sharding_round_trip(mesh_shape, x_shape):
    mesh = TM.make_mesh(mesh_shape, devices=_slots(int(np.prod(mesh_shape))))
    sh = TM.batch_sharding(mesh)
    x = torch.arange(int(np.prod(x_shape)), dtype=torch.int64) \
        .reshape(x_shape)
    pieces = sh.split(x)
    assert len(pieces) == mesh_shape[0]
    assert all(len(row) == mesh_shape[1] for row in pieces)
    rows = torch.tensor_split(x, mesh_shape[0], dim=0)
    for i, row in enumerate(pieces):
        cols = torch.tensor_split(rows[i], mesh_shape[1], dim=1)
        for j, p in enumerate(row):
            assert torch.equal(p, cols[j])
    assert torch.equal(sh.gather(pieces), x)


def test_image_sharding_and_replicated_round_trip():
    mesh = TM.make_mesh((2, 4), devices=_slots(8))
    x = torch.randn(13, 5, 3, generator=torch.Generator().manual_seed(0))
    img = TM.image_sharding(mesh)
    pieces = img.split(x)
    # rows over space; the data groups hold replicas
    for i in range(2):
        for j, p in enumerate(pieces[i]):
            assert torch.equal(p, torch.tensor_split(x, 4)[j])
    assert torch.equal(img.gather(pieces), x)
    rep = TM.replicated(mesh)
    pieces = rep.split(x)
    assert all(torch.equal(p, x) for row in pieces for p in row)
    assert torch.equal(rep.gather(pieces), x)


def test_take_reassembles_any_range():
    x = torch.arange(40).reshape(2, 20)
    bounds = TM.split_bounds(20, 6)
    blocks = [x[:, a:b] for a, b in bounds]
    for a, b in [(0, 20), (2, 9), (3, 4), (0, 1), (16, 20), (5, 6)]:
        assert torch.equal(TM.take(blocks, bounds, a, b, CPU, dim=1),
                           x[:, a:b])
    # a block asked for whole comes back as it is
    assert TM.take(blocks, bounds, *bounds[2], CPU, dim=1) is blocks[2]


def _jax_exchange(x, halo, mesh):
    f = shard_map(lambda a: JH.exchange_rows(a, halo), mesh=mesh,
                  in_specs=(P("space", None, None),),
                  out_specs=P("space", None, None))
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_exchange_rows_matches_jax(halo):
    """(1, 8) mesh, 8 rows a block: every extended block (ghost rows from
    the neighbours, zeros at the chain ends) equals the JAX exchange's."""
    rng = np.random.default_rng(7)
    x = rng.random((64, 16, 3)).astype(np.float32)
    jmesh = JM.make_mesh((1, 8))
    want = _jax_exchange(x, halo, jmesh).reshape(8, 8 + 2 * halo, 16, 3)
    blocks = [torch.from_numpy(b) for b in np.split(x, 8)]
    got = TH.exchange_rows(blocks, halo)
    for j in range(8):
        np.testing.assert_array_equal(got[j].numpy(), want[j])
    assert not got[0][:halo].any() and not got[-1][-halo:].any()


def test_exchange_rows_refuses_short_blocks():
    blocks = [torch.zeros(4, 3), torch.zeros(1, 3), torch.zeros(4, 3)]
    with pytest.raises(ValueError, match="block 1 has 1 rows"):
        TH.exchange_rows(blocks, 2)
    assert [b.shape[0] for b in TH.exchange_rows(blocks, 1)] == [6, 3, 6]


def _blur3_torch(x):
    up = torch.cat([x[:1] * 0, x[:-1]])
    dn = torch.cat([x[1:], x[-1:] * 0])
    return (up + x + dn) / 3.0


def _blur3_jax(x):
    up = jnp.concatenate([x[:1] * 0, x[:-1]], axis=0)
    dn = jnp.concatenate([x[1:], x[-1:] * 0], axis=0)
    return (up + x + dn) / 3.0


@pytest.mark.parametrize("rows", [64, 67])
def test_sharded_stencil_matches_jax(rows):
    """The 3-row blur through `sharded_stencil` on (1, 8) against the JAX
    package's sharded stencil (64 rows) and the dense blur (also 67 rows,
    blocks of 9 and 8), to 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.random((rows, 16, 3)).astype(np.float32)
    mesh = TM.make_mesh((1, 8), devices=_slots(8))
    got = TH.sharded_stencil(_blur3_torch, 1, mesh)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _blur3_torch(
        torch.from_numpy(x)).numpy(), rtol=1e-6, atol=1e-6)
    if rows % 8 == 0:
        jmesh = JM.make_mesh((1, 8))
        with jmesh:
            want = jax.jit(JH.sharded_stencil(_blur3_jax, 1, jmesh))(
                jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_sharded_stencil_replicas_and_wide_halo():
    """On a (2, 4) mesh the rows split over the space slots of the first
    data group; a 5-row stencil with halo 2 matches the dense one."""
    def blur5(x):
        p = torch.nn.functional.pad(x.T, (2, 2)).T
        return sum(p[i:i + x.shape[0]] for i in range(5)) / 5.0

    x = torch.randn(40, 7, generator=torch.Generator().manual_seed(1))
    mesh = TM.make_mesh((2, 4), devices=_slots(8))
    got = TH.sharded_stencil(blur5, 2, mesh)(x)
    torch.testing.assert_close(got, blur5(x), rtol=1e-6, atol=1e-6)
