"""The row-split matting solve, the sharded full-resolution refine, the
sharded `Pipeline` and the staged pipeline of the port on the CPU.

Slots are `torch.device("cpu")`; the JAX side runs on conftest's 8
virtual CPU devices. Against the port's own unsplit runs the solve is
expected to give equal bytes: every pixel's arithmetic is the same on
its slot and the per-image sums round once from float64. Against the JAX
package, the bounds are its own tests' (test_sharded_matting.py,
test_pipeline.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from image_segmenter_tpu.parallel import mesh as JM
from image_segmenter_tpu.pipeline.segment import Pipeline as JPipeline
from image_segmenter_tpu.solvers.matting import solve_alpha_cf as j_solve
from image_segmenter_tpu_torch.compat import matting_refine as TREF
from image_segmenter_tpu_torch.graft_entry import band_contract, \
    distinct_images
from image_segmenter_tpu_torch.models import registry as TR
from image_segmenter_tpu_torch.models.convert import state_from_flax
from image_segmenter_tpu_torch.parallel import mesh as TM
from image_segmenter_tpu_torch.pipeline.segment import Pipeline
from image_segmenter_tpu_torch.pipeline.staged import StagedPipeline, \
    split_stage_meshes
from image_segmenter_tpu_torch.processing import matting_refine as PREF
from image_segmenter_tpu_torch.solvers.matting import solve_alpha_cf
from processing.matting_refine import refine_alpha_portrait_full_res as \
    j_full_res
from test_sharded_matting import _case

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(shape):
    return TM.make_mesh(shape, devices=[CPU] * int(np.prod(shape)))


def _case_t():
    img, tri = _case()
    return (torch.from_numpy(img.astype(np.float32))[None],
            torch.from_numpy(tri.astype(np.float32))[None])


@pytest.mark.parametrize("half_stats,slots", [
    (False, 8),   # the full-inverse plain path, blocks of 8 rows
    (True, 4),    # the half_stats path of K2 / K3 (their plain versions)
    (True, 8),
    (False, 21),  # blocks of 3 and 4 rows: 2 * radius + 1 and up
    (True, 32),   # blocks of 2 rows, shorter than the ghost band
])
def test_sharded_solve_gives_the_unsplit_bytes(half_stats, slots):
    """test_sharded_matting's case (64 x 48) split over (1, slots): alpha,
    converged, iterations and residual equal to the unsplit solve's,
    bit for bit (expected: the same arithmetic at every pixel, the sums
    rounded once from float64)."""
    img, tri = _case_t()
    one = solve_alpha_cf(img, tri, max_iter=300, half_stats=half_stats)
    split = solve_alpha_cf(img, tri, max_iter=300, half_stats=half_stats,
                           mesh=_mesh((1, slots)))
    assert bool(one[1][0]) and int(one[2][0]) > 10
    for name, a, b in zip(("alpha", "ok", "iterations", "residual"), one,
                          split):
        assert torch.equal(a, b), name


def test_sharded_solve_batch_warm_start_and_conditioning():
    """Two images with a warm start on (1, 5), and the conditioning
    statistic of `solve_alpha_cf_with_conditioning`: equal to the unsplit
    solve's."""
    from image_segmenter_tpu_torch.solvers.matting import \
        solve_alpha_cf_with_conditioning as with_cond

    img, tri = _case_t()
    img = torch.cat([img, img.flip(1)])
    tri = torch.cat([tri, tri.flip(2)])
    x0 = torch.rand(2, 64, 48, generator=torch.Generator().manual_seed(0))
    kw = dict(max_iter=300, rtol=1e-4, x0=x0, half_stats=True)
    one = with_cond(img, tri, **kw)
    split = with_cond(img, tri, mesh=_mesh((1, 5)), **kw)
    assert one[2].tolist() != [0, 0]
    for a, b in zip(one, split):
        assert torch.equal(a, b)


def test_sharded_solve_refuses_a_data_axis():
    img, tri = _case_t()
    with pytest.raises(ValueError, match="one data group"):
        solve_alpha_cf(img, tri, mesh=_mesh((2, 2)))


def test_sharded_solve_matches_jax_sharded():
    """test_sharded_matting.test_solver_matches_dense_under_sharding's
    solve on (1, 8) in both packages: within its 4e-3."""
    img, tri = _case()
    jmesh = JM.make_mesh((1, 8))
    sh_img = jax.device_put(jnp.asarray(img, jnp.float32),
                            NamedSharding(jmesh, P("space", None, None)))
    sh_tri = jax.device_put(jnp.asarray(tri, jnp.float32),
                            NamedSharding(jmesh, P("space", None)))
    with jmesh:
        a_j, ok_j, _, _ = j_solve(sh_img, sh_tri, max_iter=300)
    a_t, ok_t, _, _ = solve_alpha_cf(*_case_t(), max_iter=300,
                                     mesh=_mesh((1, 8)))
    assert bool(ok_j) and bool(ok_t[0])
    np.testing.assert_allclose(a_t[0].numpy(), np.asarray(a_j), atol=4e-3)


def test_full_res_refine_with_mesh_matches_jax():
    """test_sharded_matting.test_full_res_api_matches_small_path's inputs
    through the shim: the port on (1, 8) against JAX on (1, 8) within its
    bounds, against the port's unsplit refine byte for byte, strokes
    enforced."""
    h, w = 48, 64
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, : w // 2] = [200, 50, 50]
    rgb[:, w // 2:] = [30, 30, 180]
    alpha = np.zeros((h, w), np.uint8)
    alpha[:, : w // 2] = 255
    mesh = _mesh((1, 8))
    jmesh = JM.make_mesh((1, 8))

    out_t = PREF.refine_alpha_portrait_full_res(rgb, alpha, None, mesh=mesh)
    out_j = j_full_res(rgb, alpha, None, mesh=jmesh)
    assert (out_t != out_j).mean() < 0.01
    assert (out_t[:, : w // 4] > 200).mean() > 0.9
    assert (out_t[:, -w // 4:] < 50).mean() > 0.9
    np.testing.assert_array_equal(
        out_t, TREF.refine_alpha_portrait_full_res(rgb, alpha, None,
                                                   device="cpu"))

    user = np.zeros((h, w), np.uint8)
    user[0, 0] = 2
    user[-1, -1] = 1
    out_u = PREF.refine_alpha_portrait_full_res(rgb, alpha, user, mesh=mesh)
    assert out_u[0, 0] == 0 and out_u[-1, -1] == 255
    out_ju = j_full_res(rgb, alpha, user, mesh=jmesh)
    assert (out_u != out_ju).mean() < 0.01


@pytest.fixture(scope="module")
def noise_run():
    """test_pipeline.test_pipeline_data_sharded's batch through the JAX
    package on (4, 1) and through the port, sharded on (2, 2) and on one
    slot, all with the JAX package's seeded weights."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    jmesh = JM.make_mesh((4, 1))
    jp = JPipeline(model="u2netp", k=4, cg_iters=20,
                   sharding=JM.batch_sharding(jmesh))
    with jmesh:
        j_rgba = np.asarray(jp.run(imgs).rgba)
    state = state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jp.session.variables))

    def port(**kw):
        pipe = Pipeline(model="u2netp", k=4, cg_iters=20, **kw)
        # a fresh session with the JAX weights (the cached one stays as is)
        pipe.session = TR.Session("u2netp", device="cpu")
        pipe.session.load_state_dict(state)
        return pipe

    sharded = port(sharding=TM.batch_sharding(_mesh((2, 2))))
    one = port(device="cpu")
    return imgs, j_rgba, sharded, one


def _jax_bounds(a, b, imgs):
    """test_pipeline.py:31-54: alpha near-identical, quantization error
    within 1.2x + 50."""
    assert (a[..., 3] != b[..., 3]).mean() < 0.01
    for i in range(len(imgs)):
        nt = a[i, ..., 3] > 0
        if not nt.any():
            continue
        err_a = ((a[i, ..., :3].astype(float) - imgs[i]) ** 2)[nt].mean()
        err_b = ((b[i, ..., :3].astype(float) - imgs[i]) ** 2)[nt].mean()
        assert err_a <= err_b * 1.2 + 50.0, (i, err_a, err_b)


def test_sharded_pipeline_matches_one_slot_and_jax(noise_run):
    """Pipeline(sharding=(2, 2)) against the port's one-slot run under the
    dry run's boundary-band contract, and against the JAX package's
    data-sharded run under test_pipeline.py's bounds."""
    imgs, j_rgba, sharded, one = noise_run
    out = sharded.run(imgs)
    assert tuple(out.rgba.shape) == (4, 64, 64, 4)
    assert out.rgba.device == CPU
    rgba = out.rgba.numpy()
    ref = one.run(imgs).rgba.numpy()
    band_contract(rgba, ref, imgs, "sharded vs one slot")
    _jax_bounds(rgba, j_rgba, imgs)


def test_sharded_stages_from_one_mask_give_the_unsplit_bytes(noise_run):
    """From one CNN mask the matting (rows split over 2 slots) and
    quantize stages sharded over (2, 2) give the one-slot bytes."""
    imgs, _, sharded, one = noise_run
    mask = one.stages.cnn(one.session.module, torch.from_numpy(imgs))
    a = sharded.run_from_mask(imgs, mask)
    b = one.run_from_mask(imgs, mask)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_sharded_pipeline_distinct_images_and_repeat():
    """Distinct images (a permuted or mixed batch would show) on a (3, 2)
    mesh with 4 images (an uneven split): the dry run's contract against
    one slot, and a second run is bit-identical."""
    imgs = distinct_images(4)
    pipe = Pipeline(model="u2netp", k=4, cg_iters=20,
                    sharding=TM.batch_sharding(_mesh((3, 2))))
    out = pipe.run(imgs)
    again = pipe.run(imgs)
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    ref = Pipeline(model="u2netp", k=4, cg_iters=20, device="cpu").run(imgs)
    band_contract(out.rgba.numpy(), ref.rgba.numpy(), imgs, "(3, 2)")
    # the run lives on the mesh's slots: the default device is not read
    assert pipe.device == CPU and out.rgba.device == CPU


@pytest.mark.parametrize("sharded", [False, True])
def test_an_empty_batch_is_refused(sharded):
    """A batch of no image is refused before any work, on one slot (one
    data group) and sharded alike."""
    kw = dict(sharding=TM.batch_sharding(_mesh((2, 1)))) if sharded \
        else dict(device="cpu")
    pipe = Pipeline(model="u2netp", k=4, cg_iters=20, **kw)
    with pytest.raises(ValueError, match="B >= 1"):
        pipe.run(np.zeros((0, 32, 32, 3), np.uint8))


def test_split_stage_meshes_sizes():
    meshes = split_stage_meshes([CPU] * 8, fractions=(2, 1, 1))
    assert [m.size for m in meshes] == [4, 2, 2]
    assert [m.size for m in split_stage_meshes([CPU] * 3)] == [1, 1, 1]
    assert [m.size for m in split_stage_meshes([CPU] * 5)] == [2, 2, 1]
    with pytest.raises(ValueError, match=">= 3 devices"):
        split_stage_meshes([CPU] * 2)


def test_staged_pipeline_matches_fused():
    """test_pipeline.test_staged_pipeline_matches_fused on the port: three
    distinguishable batches streamed through [4, 2, 2] slots come out in
    order, each within that test's bounds of the fused run and under the
    dry run's boundary-band contract."""
    meshes = split_stage_meshes([CPU] * 8, fractions=(2, 1, 1))
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    base = np.stack([127 + 90 * np.sin(xx / 13), 127 + 90 * np.cos(yy / 9),
                     127 + 90 * np.sin((xx + yy) / 17)], -1)
    batches = [np.clip(base + rng.normal(0, 6, base.shape), 0, 255)
               .astype(np.uint8)[None].repeat(4, axis=0) for _ in range(3)]
    for i, b in enumerate(batches):  # make batches distinguishable
        b[:, :8, :8] = 10 * (i + 1)

    staged = StagedPipeline(model="u2netp", k=4, cg_iters=20, meshes=meshes,
                            device="cpu")
    fused = Pipeline(model="u2netp", k=4, cg_iters=20, device="cpu")
    outs = list(staged.run_stream(batches))
    assert len(outs) == 3
    for b, out in zip(batches, outs):
        ref = fused.run(b)
        a, c = out.rgba.numpy(), ref.rgba.numpy()
        _jax_bounds(a, c, b)
        band_contract(a, c, b, "staged vs fused")
        assert tuple(out.alpha.shape) == (4, 64, 64)
        assert tuple(out.palettes.shape) == (4, 4, 3)
