"""The loops and programs of the port's compiled GrabCut, on the CPU.

On the card each GrabCut unit (init, one alternation, the standardized
energy, a polish round) is a program captured as CUDA graphs, its loops
(the Chambolle-Pock cut, `CPLoop`; each k-means restart, `kmeans.
RestartLoop`) replayed a chunk at a time until their flags clear. CUDA
graphs cannot run here, but what they replay can: `_replayed` below
drives a program as `pipeline/compiled.Compiled` replays it, each loop's
`step` until its flag clears, where `drive` (the eager run) calls each
loop's `run`. Tolerances:

- every chunk size of `CPLoop.step` gives the bits of a chunk of one, and
  of the cut loop as it stood before the loops became objects
  (`_legacy_tv_mincut`, a copy), at a cap inside a chunk, with lanes that
  stop at different iterations, cold and warm;
- `RestartLoop.step` (its reseed branchless) gives the bits of its `run`
  (the reseed behind a host branch) and of the restart loop as it stood
  before (`_legacy_lloyd_restarts`, a copy), on points that empty
  clusters, at n_init 3 (one restart at a time) and 10 (lock step);
- every GrabCut program replayed gives the bits of its eager run;
- `grabcut_core` replayed gives the eager run's bytes, cut iterations and
  restart flag, through the collapse restart and both polish paths;
- `grabcut_core` is held to the JAX package's on the first four corpus
  photos at 96 x 96: on china and flower, the photos with a subject,
  equal mask bytes and each alternation's cut iterations within 5 %
  (`tests/test_torch_grabcut.py`'s bound for the cut: 1807 against 1806
  on china's first cut). The two sky textures have no subject (PARITY.md's
  degenerate class, where the EM takes an arbitrary cut in either
  package: 0.77 and 0.94 of the bytes agree, and on sky_01-up the port's
  collapse restart is accepted where JAX's is not), and there only the
  contract holds (known pixels pass through, values in {0, 1, 2, 3}).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_segmenter_tpu.solvers import grabcut as JG
from image_segmenter_tpu_torch.bench import corpus as CORPUS
from image_segmenter_tpu_torch.pipeline import compiled as CP
from image_segmenter_tpu_torch.solvers import grabcut as TG
from image_segmenter_tpu_torch.solvers import kmeans as TKM
from image_segmenter_tpu_torch.utils import loops as LP
from image_segmenter_tpu_torch.utils import prng as P
from image_segmenter_tpu_torch.utils.seeds import config4_rect
from test_torch_grabcut import _homogeneous_scene, _rect_mask, _scene, \
    _stroke_mask

torch.set_num_threads(2)

H, W = 48, 64


def _replayed(program):
    """Run a program as its compiled graphs replay it: each loop's `step`
    until its flag clears (`drive` calls each loop's `run`)."""
    try:
        loop = next(program)
        while True:
            while bool(loop.flag):
                loop.step()
            loop = program.send(None)
    except StopIteration as stop:
        return stop.value


def _leaves(x) -> list:
    out = []
    TG._flatten(x, out)
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert torch.equal(x, y), (i, (x.double() - y.double()).abs().max())


# ---------------------------------------------------------------------------
# the Chambolle-Pock loop
# ---------------------------------------------------------------------------

def _legacy_tv_mincut(unary, edge_weights, fixed_fg, fixed_bg, max_iter=2000,
                      warm_y=None, chunk=50):
    """The cut as `solvers/grabcut.tv_mincut` ran it before `CPLoop`: a
    closure body, chunks of at most max_iter - done, one read a chunk."""
    c, h, w = unary.shape
    dev = unary.device
    wts = edge_weights
    deg = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for i, (dy, dx, _) in enumerate(TG._DIRS):
        has_e = (wts[i] > 0).to(torch.float32)
        deg = deg + has_e + TG._shift(has_e, -dy, -dx)
    tau = torch.reciprocal(torch.clamp_min(deg, 1.0))
    sigma = 0.5
    lo = fixed_fg.to(torch.float32)
    hi = (~fixed_bg).to(torch.float32)
    neg_wts = -wts
    u = torch.clamp((unary <= 0).to(torch.float32), lo, hi)
    ubar = u
    if warm_y is None:
        y = torch.zeros((c, 4, h, w), dtype=torch.float32, device=dev)
    else:
        y = torch.clamp(warm_y, neg_wts, wts)
    it = torch.zeros((c,), dtype=torch.int32, device=dev)
    delta = torch.full((c,), float("inf"), device=dev)

    def running(it, delta):
        return (it < max_iter) & ((delta > 2e-5) | (it < 50))

    def body(u, ubar, y, it, delta):
        active = running(it, delta)
        pu = F.pad(ubar, (1, 1, 1, 1))
        nb = torch.stack([pu[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy, dx, _ in TG._DIRS], dim=1)
        y_new = torch.clamp(y + sigma * (ubar[:, None] - nb), neg_wts, wts)
        py = F.pad(y_new, (1, 1, 1, 1))
        div = None
        for i, (dy, dx, _) in enumerate(TG._DIRS):
            back = py[:, i, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
            div = y_new[:, i] - back if div is None \
                else div + y_new[:, i] - back
        u_new = torch.clamp(u - tau * (unary + div), lo, hi)
        ubar_new = 2.0 * u_new - u
        d_new = torch.abs(u_new - u).amax(dim=(1, 2))
        a3 = active[:, None, None]
        return (torch.where(a3, u_new, u), torch.where(a3, ubar_new, ubar),
                torch.where(a3[:, None], y_new, y),
                it + active.to(torch.int32), torch.where(active, d_new, delta))

    done = 0
    while done < max_iter:
        n = min(chunk, max_iter - done)
        for _ in range(n):
            u, ubar, y, it, delta = body(u, ubar, y, it, delta)
        done += n
        if not bool(running(it, delta).any()):
            break
    return u, it, y


@pytest.fixture(scope="module")
def cut_case():
    """Two lanes of a first alternation's unary on the homogeneous scene
    (the second scaled and shifted, so the lanes stop apart), its n-link
    weights, the rect's known background and a seeded warm dual."""
    img = _homogeneous_scene(0, h=H, w=W)
    im = TG.prepare(torch.from_numpy(img))
    mask = torch.from_numpy(_rect_mask(H, W, 6))
    fg, bg = TG._grabcut_init(im, mask)
    unary = (TG._data_term(im.pixels, fg)
             - TG._data_term(im.pixels, bg)).reshape(1, H, W)
    unary = torch.cat([unary, 0.5 * unary + 0.3])
    fixed_fg = torch.zeros((2, H, W), dtype=torch.bool)
    fixed_bg = (mask == TG.BGD)[None].expand(2, H, W).clone()
    warm = torch.from_numpy(np.random.default_rng(0).normal(
        0, 5, (2, 4, H, W)).astype(np.float32))
    return unary, im.edge_w, fixed_fg, fixed_bg, warm


# case -> (max_iter, warm)
CP_CASES = {"cold": (2500, False), "warm": (2500, True), "cap": (83, True)}


def _stepped_cut(case, cut_case, chunk):
    max_iter, warm = CP_CASES[case]
    unary, wts, ffg, fbg, warm_y = cut_case
    loop = TG.CPLoop(unary, wts, ffg, fbg, max_iter=max_iter,
                     warm_y=warm_y if warm else None, chunk=chunk)
    while bool(loop.flag):
        loop.step()
    return loop


@pytest.mark.parametrize("case", sorted(CP_CASES))
@pytest.mark.parametrize("chunk", sorted({7, 50, TG.CP_CHUNK}))
def test_cp_loop_chunks_are_a_chunk_of_one(case, chunk, cut_case):
    """u, ubar, y, it and delta of every lane, bit for bit, against a
    chunk of one and against the cut before the loop object. At the cap
    of 83 both lanes stop inside a chunk of 7 and of 50; otherwise they
    stop at different iterations."""
    ref = _stepped_cut(case, cut_case, 1)
    got = _stepped_cut(case, cut_case, chunk)
    for name in ("u", "ubar", "y", "it", "delta"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    its = got.it.tolist()
    if case == "cap":
        assert its == [83, 83]
    else:
        assert its[0] != its[1] and max(its) < 2500
    max_iter, warm = CP_CASES[case]
    unary, wts, ffg, fbg, warm_y = cut_case
    old = _legacy_tv_mincut(unary, wts, ffg, fbg, max_iter=max_iter,
                            warm_y=warm_y if warm else None, chunk=chunk)
    for a, b in zip((got.u, got.it, got.y), old):
        assert torch.equal(a, b)


def test_cp_loop_steps_in_place(cut_case):
    """`step` writes the same tensors, the addresses a CUDA graph of it
    reads and writes, and counts a chunk of iterations of a running lane;
    `tv_mincut` is the loop run eagerly."""
    unary, wts, ffg, fbg, _ = cut_case
    loop = TG.CPLoop(unary, wts, ffg, fbg, max_iter=2500, chunk=7)
    state = [loop.u, loop.ubar, loop.y, loop.it, loop.delta, loop.flag]
    ptrs = [t.data_ptr() for t in state]
    loop.step()
    assert [t.data_ptr() for t in state] == ptrs
    assert loop.it.tolist() == [7, 7] and bool(loop.flag)
    loop.run()
    u, it, y = TG.tv_mincut(unary, wts, ffg, fbg, max_iter=2500)
    assert torch.equal(u, loop.u) and torch.equal(it, loop.it) \
        and torch.equal(y, loop.y)


# ---------------------------------------------------------------------------
# the k-means restarts
# ---------------------------------------------------------------------------

def _legacy_lloyd_restarts(pts, w, centers_all, max_iter, tol):
    """The restart Lloyd as `solvers/kmeans._lloyd_restarts` ran it before
    `RestartLoop`: one host read an iteration, the reseed behind it."""
    nb, blk, d = pts.shape
    r, k, _ = centers_all.shape
    ptsT = pts.transpose(1, 2).contiguous()
    bins = torch.arange(k)[None, :, None]

    def assign_stats(call):
        sums = torch.zeros((r, k, d), dtype=torch.float32)
        counts = torch.zeros((r, k), dtype=torch.float32)
        inertia = torch.zeros((r,), dtype=torch.float32)
        for j in range(nb):
            d2 = TKM._d2_points_last(ptsT[j], call)
            dmin, lbl = torch.min(d2, dim=1)
            onehot = (lbl[:, None, :] == bins).to(torch.float32) * w[j]
            sums = sums + TKM.tree_sum(onehot[:, :, None, :] * ptsT[j])
            counts = counts + TKM.tree_sum(onehot)
            inertia = inertia + TKM.tree_sum(dmin * w[j])
        return sums, counts, inertia

    def reseed_empty(call, counts):
        md = torch.cat([TKM._d2_points_last(ptsT[j], call).amin(dim=1)
                        * (w[j] > 0) for j in range(nb)], dim=1)
        far_pts = pts.reshape(-1, d)[TKM._top_k_indices(md, k)]
        empty = counts == 0
        slot = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=1) - 1,
                           0, k - 1)
        return torch.where(empty[..., None], TKM._gather_rows(far_pts, slot),
                           call)

    call = centers_all
    shift2 = torch.full((r,), float("inf"))
    moving = bool((shift2 > tol).any())
    it = 0
    while moving and it < max_iter:
        active = shift2 > tol

        def advance(new):
            new = torch.where(active[:, None, None], new, call)
            diff = new - call
            return new, TKM.tree_sum((diff * diff).reshape(r, -1))

        sums, counts, _ = assign_stats(call)
        mean = torch.where(counts[..., None] > 0,
                           sums / torch.clamp_min(counts, 1.0)[..., None], call)
        new, new_shift2 = advance(mean)
        any_empty, moving = torch.stack(
            [(counts == 0).any(), (new_shift2 > tol).any()]).tolist()
        if any_empty:
            new, new_shift2 = advance(reseed_empty(mean, counts))
            moving = bool((new_shift2 > tol).any())
        call, shift2 = new, new_shift2
        it += 1
    rounded = torch.round(call)
    call = torch.where(torch.abs(call - rounded) < 1e-3, rounded, call)
    _, _, inertia = assign_stats(call)
    best = torch.argmin(inertia)
    return call[best], inertia[best]


def _restart_points(case):
    """(points (N, 3), weights (N,), k, n_init, max_iter)."""
    rng = np.random.default_rng(5)
    if case == "empty":  # three colours for five clusters: reseeds
        cols = np.array([[10, 10, 10], [200, 30, 30], [30, 200, 30]])
        pts = cols[rng.integers(0, 3, 1500)]
        w = np.ones(1500)
        k, n_init, max_iter = 5, 3, 30
    else:
        img, _ = _scene(3, h=40, w=50)
        pts = img.reshape(-1, 3)
        w = (rng.random(len(pts)) > 0.3).astype(np.float64)
        k, n_init, max_iter = {"n_init3": (5, 3, 30), "n_init10": (5, 10, 30),
                               "cap": (8, 10, 4)}[case]
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.from_numpy(w.astype(np.float32)), k, n_init, max_iter)


def _legacy_fit(pts, w, k, n_init, max_iter, seed=42):
    """`kmeans_fit` as it stood before the restart loop object."""
    ptsb, wb = TKM._pad_points(pts[None], w[None])
    p, ww = ptsb[0], wb[0]
    nb, blk, d = p.shape
    tol = TKM._tolerance(p.reshape(1, nb * blk, d), ww.reshape(1, nb * blk),
                         k)[0]
    trials = 2 + int(np.log(max(k, 2)))
    keys = [P.fold_in(P.key(seed), i) for i in range(n_init)]
    c0 = TKM._kmeanspp_init(keys, p, ww, k, trials)
    if n_init >= 4:
        return _legacy_lloyd_restarts(p, ww, c0, max_iter, tol)
    best = (torch.zeros((k, d)), torch.full((), float("inf")))
    for i in range(n_init):
        c, inertia = _legacy_lloyd_restarts(p, ww, c0[i:i + 1], max_iter, tol)
        better = inertia < best[1]
        best = (torch.where(better, c, best[0]),
                torch.where(better, inertia, best[1]))
    return best


@pytest.mark.parametrize("case", ["empty", "n_init3", "n_init10", "cap"])
def test_restart_loop_branchless_step_is_the_host_branched_run(
        case, monkeypatch):
    """`kmeans_fit` replayed (RestartLoop.step, a reseed every iteration
    kept only in empty slots) against its eager run (the reseed behind a
    host read) and against the fit before the loop object: centres,
    inertia and each restart's iterations, bit for bit. On "empty" the
    host branch reseeds; at "cap" restarts stop at max_iter 4."""
    pts, w, k, n_init, max_iter = _restart_points(case)
    reseeds = []
    real = TKM.RestartLoop._reseed_empty

    def counted(self, call, counts):
        reseeds.append(int((counts == 0).sum()))
        return real(self, call, counts)

    def fit(run):
        loops = []
        res = run(_tracking(TKM.kmeans_fit_program(
            pts, w, k, n_init=n_init, max_iter=max_iter, seed=7), loops))
        return res, [lp.it.clone() for lp in loops]

    monkeypatch.setattr(TKM.RestartLoop, "_reseed_empty", counted)
    eager, eager_it = fit(LP.drive)
    host_reseeds = len(reseeds)
    stepped, stepped_it = fit(_replayed)
    assert torch.equal(stepped.centers, eager.centers)
    assert torch.equal(stepped.inertia, eager.inertia)
    assert [t.tolist() for t in stepped_it] == [t.tolist() for t in eager_it]
    assert len(eager_it) == (1 if n_init >= 4 else n_init)
    old_c, old_i = _legacy_fit(pts, w, k, n_init, max_iter, seed=7)
    assert torch.equal(eager.centers, old_c)
    assert torch.equal(eager.inertia, old_i)
    assert torch.equal(TKM.kmeans_fit(pts, w, k, n_init=n_init,
                                      max_iter=max_iter, seed=7).centers,
                       old_c)
    if case == "empty":
        assert host_reseeds > 0
    if case == "cap":
        assert max(max(t.tolist()) for t in eager_it) == 4


def _tracking(program, loops: list):
    """`program`, with each loop it yields appended to `loops`."""
    try:
        loop = next(program)
        while True:
            loops.append(loop)
            yield loop
            loop = program.send(None)
    except StopIteration as stop:
        return stop.value


@pytest.mark.parametrize("case", ["empty", "n_init3", "n_init10", "cap"])
def test_lanes_fit_is_each_lanes_own_fit(case):
    """`kmeans_fit_lanes_program` on four weightings of the same points
    (one with no weight at all), eagerly and stepped as the graphs replay
    it: each lane's centres and inertia are those of `kmeans_fit` on its
    own weights with the restarts one after another, bit for bit (one
    lane of the same program), and of the fit as it stood before the
    loop objects (`_legacy_fit`, a copy)."""
    pts, w, k, n_init, max_iter = _restart_points(case)
    rng = np.random.default_rng(11)
    lanes = torch.stack([w, w * torch.from_numpy(
        (rng.random(len(w)) > 0.5).astype(np.float32)),
        torch.flip(w, [0]), torch.zeros_like(w)])
    for run in (LP.drive, _replayed):
        got = run(TKM.kmeans_fit_lanes_program(
            pts, lanes, k, n_init=n_init, max_iter=max_iter, seed=5))
        assert got.centers.shape == (4, k, 3)
        for i, wl in enumerate(lanes):
            ref = TKM.kmeans_fit(pts, wl, k, n_init=n_init, max_iter=max_iter,
                                 seed=5, batch_restarts=False)
            assert torch.equal(got.centers[i], ref.centers), (run, i)
            assert torch.equal(got.inertia[i], ref.inertia), (run, i)
            if n_init < 4:  # the old fit's restarts one after another
                old = _legacy_fit(pts, wl, k, n_init, max_iter, seed=5)
                assert torch.equal(got.centers[i], old[0]), (run, i)
                assert torch.equal(got.inertia[i], old[1]), (run, i)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_restart_loop_chunks_are_a_chunk_of_one(chunk, monkeypatch):
    """RestartLoop.step at any chunk: the bits and iterations of a chunk
    of one, with ten restarts that stop at different iterations."""
    pts, w, k, n_init, max_iter = _restart_points("n_init10")

    def fit(c):
        monkeypatch.setattr(TKM, "RESTART_CHUNK", c)
        loops = []
        res = _replayed(_tracking(TKM.kmeans_fit_program(
            pts, w, k, n_init=n_init, max_iter=max_iter, seed=3), loops))
        return res, loops[0].it

    ref, ref_it = fit(1)
    got, it = fit(chunk)
    assert torch.equal(got.centers, ref.centers)
    assert torch.equal(got.inertia, ref.inertia)
    assert torch.equal(it, ref_it) and len(set(it.tolist())) > 1


# ---------------------------------------------------------------------------
# the GrabCut programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def state():
    """A scene after two alternations from the stroke mask: the image,
    the mask, the GMMs and the dual."""
    img, blob = _scene(8, h=H, w=W)
    im = TG.prepare(torch.from_numpy(img))
    mt = torch.from_numpy(_stroke_mask(blob))[None]
    fg, bg = TG._grabcut_init(im, mt[0])
    m, fg, bg, y, _ = TG._run_alternations(im, mt, fg, bg, None, 2)
    return im, mt, m, fg, bg, y


def _lanes(x, n):
    return x.expand(n, *x.shape[1:]).contiguous()


def _unit(name, st):
    im, m0, m, fg, bg, y = st
    rng = np.random.default_rng(4)
    fg01 = torch.from_numpy(
        (rng.random((10, H, W)) < 0.4).astype(np.float32)) * TG._fg_of(m)
    g10 = TG._gmm_map(lambda t: _lanes(t, 10), fg)
    b10 = TG._gmm_map(lambda t: _lanes(t, 10), bg)
    m10 = torch.where(torch.from_numpy(rng.random((10, H, W)) < 0.05),
                      torch.full_like(m, TG.PR_FGD), m.expand(10, H, W))
    return {
        "init": (TG._init_program, (im, m0[0]), {"seed": 42}),
        "iter1_cold": (TG._iter_program, (im, m, fg, bg, None), {}),
        "iter1_warm": (TG._iter_program, (im, m, fg, bg, y), {}),
        "iter10_warm": (TG._iter_program, (im, m10, g10, b10, _lanes(y, 10)),
                        {}),
        "energy1": (TG._energy_program, (im, fg01[:1]), {}),
        "energy2": (TG._energy_program, (im, fg01[:2]), {}),
        "energy10": (TG._energy_program, (im, fg01), {}),
        "round": (TG._accepted_round_program,
                  (im, m, fg, bg, y, torch.tensor(1e30)), {"extra_iters": 1}),
    }[name]


@pytest.mark.parametrize("name", ["init", "iter1_cold", "iter1_warm",
                                  "iter10_warm", "energy1", "energy2",
                                  "energy10", "round"])
def test_program_replayed_is_its_eager_run(name, state):
    """Each unit's program, its loops stepped as the graphs replay them,
    gives the bits of its eager run (the unit on the CPU); the polish
    round accepts against an incumbent of 1e30."""
    program, args, static = _unit(name, state)
    eager = LP.drive(program(*args, **static))
    _assert_same(_replayed(program(*args, **static)), eager)
    if name == "round":
        assert bool(eager[-1])
    if name.startswith("energy"):  # a lane's bits at any lane count
        single = torch.cat([LP.drive(program(args[0], f[None]))
                            for f in args[1]])
        assert torch.equal(eager, single)


def test_units_on_the_cpu_are_the_eager_programs(state):
    """`_run` on CPU tensors drives the program: the units' functions
    return what their programs return, and no program is compiled."""
    im, m0, m, fg, bg, y = state
    TG.clear_programs()
    _assert_same(TG._grabcut_iter(im, m, fg, bg, y),
                 LP.drive(TG._iter_program(im, m, fg, bg, y)))
    _assert_same(TG.mask_energy(im, TG._fg_of(m)),
                 LP.drive(TG._energy_program(im, TG._fg_of(m))))
    assert not TG._PROGRAMS


def test_flatten_round_trip(state):
    """A unit's arguments (an Image, GMMs, None, tensors) flatten to their
    tensors in order and back to the same nest."""
    im, _, m, fg, bg, y = state
    args = (im, m, fg, bg, None, y)
    leaves = []
    spec = TG._flatten(args, leaves)
    assert len(leaves) == 3 + 1 + 5 + 5 + 1
    back = TG._unflatten(spec, iter(leaves))
    assert isinstance(back[0], TG.Image) and isinstance(back[2], TG.GMM)
    assert back[4] is None
    _assert_same(back, args)
    hash(spec)  # a key of the program cache


class _Count(LP.Loop):
    def __init__(self, n):
        self.n, self.steps = n, 0
        self.flag = torch.tensor(True)

    def step(self):
        self.steps += 1
        self.flag = torch.tensor(self.steps < self.n)


def test_warm_up_steps_each_loop_once():
    """`warm_up` runs the program with each loop stepped once; `drive`
    runs each to its end; Compiled takes a CUDA device only."""
    loops = [_Count(5), _Count(3)]

    def program():
        for lp in loops:
            yield lp
        return tuple(lp.steps for lp in loops)

    assert LP.warm_up(program()) == (1, 1)
    assert LP.drive(program()) == (5, 3)
    with pytest.raises(ValueError):
        CP.Compiled(program, [((2,), torch.float32)], torch.device("cpu"))


SHAPES = [((96, 128), "cuda:0"), ((128, 96), "cuda:0"), ((64, 192), "cuda:0"),
          ((192, 64), "cuda:0"), ((96, 128), "cuda:1")]


@pytest.mark.parametrize("kept", [1, 2, 3])
def test_program_groups_keep_the_last_shapes(kept, monkeypatch):
    """The compiled units are kept in groups, one an image shape and
    device: after five shapes the last `PROGRAM_SHAPES` groups are left,
    each with its programs, and every group dropped released its memory
    (the release is stubbed here: there is no card)."""
    released = []
    monkeypatch.setattr(TG, "_release", lambda: released.append(1))
    monkeypatch.setattr(TG, "_PROGRAMS", collections.OrderedDict())
    monkeypatch.setattr(TG, "PROGRAM_SHAPES", kept)
    for i, key in enumerate(SHAPES):
        TG._group(key)["unit"] = (f"program {i}", None)
        assert len(TG._PROGRAMS) == min(i + 1, kept)
    assert list(TG._PROGRAMS) == SHAPES[-kept:]
    assert TG.programs() == [f"program {i}" for i in range(5 - kept, 5)]
    assert len(released) == 5 - kept


def test_program_group_used_again_is_kept(monkeypatch):
    """A group used again becomes the most recent: a new shape drops
    the group used least recently, not the one made first; and
    `clear_programs` drops every group."""
    released = []
    monkeypatch.setattr(TG, "_release", lambda: released.append(1))
    monkeypatch.setattr(TG, "_PROGRAMS", collections.OrderedDict())
    monkeypatch.setattr(TG, "PROGRAM_SHAPES", 2)
    first = TG._group(SHAPES[0])
    first["unit"] = ("program 0", None)
    TG._group(SHAPES[1])
    assert TG._group(SHAPES[0]) is first and not released
    TG._group(SHAPES[2])
    assert list(TG._PROGRAMS) == [SHAPES[0], SHAPES[2]]
    assert TG._group(SHAPES[0]) is first and released == [1]
    TG.clear_programs()
    assert not TG._PROGRAMS and released == [1, 1]


def test_prng_key_words_are_made_once():
    """The key words: the uint32 words as int32, made once per (keys,
    device) and kept (on the card outside a capture); the draws keep
    threefry's bits."""
    keys = [P.fold_in(P.key(42), i) for i in range(3)]
    P._WORDS.clear()
    k1, k2 = P._key_words(keys, "cpu")
    ref = torch.tensor([[P._s32(a), P._s32(b)] for a, b in keys],
                       dtype=torch.int32)
    assert torch.equal(torch.cat([k1, k2], dim=1), ref)
    again = P._key_words(keys, torch.device("cpu"))
    assert again[0].data_ptr() == k1.data_ptr() and len(P._WORDS) == 1
    for i, k in enumerate(keys):
        assert torch.equal(P._bits32(keys, (4, 5), "cpu")[i],
                           P._bits32([k], (4, 5), "cpu")[0])


# ---------------------------------------------------------------------------
# grabcut_core replayed and eager; on corpus photos against JAX
# ---------------------------------------------------------------------------

def _solve(bgr, mask, **kw):
    out = TG.grabcut_core(bgr, mask, iterations=kw.pop("iterations", 10),
                          device="cpu", **kw).numpy()
    info = TG.LAST_SOLVE_INFO
    return out, info["cut_iters"], info.get("restart_accepted")


# case -> (scene, init mask, polish search dim)
CORE_CASES = {
    "rect": (lambda: _scene(5, h=H, w=W)[0], lambda: _rect_mask(H, W, 6), 256),
    "stroke": (lambda: _scene(8, h=H, w=W)[0],
               lambda: _stroke_mask(_scene(8, h=H, w=W)[1]), 256),
    # the alternation collapses to an empty foreground: the restart runs
    "collapse": (lambda: _homogeneous_scene(0, 20, 30, 10, h=H, w=W),
                 lambda: _rect_mask(H, W, 6), 256),
    # the polish's coarse search and full-resolution acceptance
    "coarse": (lambda: _scene(6, h=H, w=W)[0], lambda: _rect_mask(H, W, 6),
               32),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_grabcut_core_replayed_is_eager(case, monkeypatch):
    """grabcut_core with every unit's loops stepped as the graphs replay
    them: the eager run's mask bytes, cut iterations and restart flag,
    through the plain alternation, the collapse restart and both paths of
    the polish."""
    scene, init, search = CORE_CASES[case]
    bgr, mask = scene(), init()
    monkeypatch.setattr(TG, "DEFAULTS", dataclasses.replace(
        TG.DEFAULTS, grabcut_polish_search_dim=search))
    eager = _solve(bgr, mask, iterations=5)
    if case == "collapse":
        assert eager[2] is not None  # the restart ran
    monkeypatch.setattr(TG, "drive", _replayed)
    replayed = _solve(bgr, mask, iterations=5)
    assert np.array_equal(replayed[0], eager[0])
    assert replayed[1:] == eager[1:]


PHOTO_SIZE = 96
SUBJECT = ("china", "flower")  # the photos with a subject


@pytest.fixture(scope="module")
def photos():
    return dict(CORPUS.load_corpus(size=PHOTO_SIZE, limit=4))


@pytest.mark.parametrize("name", ["china", "flower", "sky_01-up",
                                  "sky_02-up"])
def test_grabcut_core_on_corpus_photos_against_jax(name, photos):
    """Config 4's rect on the first four corpus photos at 96 x 96, 10
    alternations and the polish: on the photos with a subject the JAX
    package's mask bytes and each cut's iterations within 5 %; on every
    photo the contract."""
    bgr = np.ascontiguousarray(photos[name][..., ::-1])
    x, y, rw, rh = config4_rect(PHOTO_SIZE, PHOTO_SIZE)
    mask = np.zeros((PHOTO_SIZE, PHOTO_SIZE), np.uint8)
    mask[y:y + rh, x:x + rw] = TG.PR_FGD
    got, its, _ = _solve(bgr, mask)
    ref = np.asarray(JG.grabcut_core(jnp.asarray(bgr), jnp.asarray(mask),
                                     iterations=10))
    ref_its = JG.LAST_SOLVE_INFO["cut_iters"]
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1, 2, 3}
    known = (mask == TG.BGD) | (mask == TG.FGD)
    assert (got[known] == mask[known]).all()
    assert len(its) == len(ref_its) == 10
    if name in SUBJECT:
        assert np.array_equal(got, ref)
        for a, b in zip(its, ref_its):
            assert abs(a - b) <= 0.05 * b, (its, ref_its)
