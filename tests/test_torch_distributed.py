"""The port's process group, hybrid mesh and sharded training step
(parallel/distributed.py, pipeline/train.shard_train_step) and its dry
run (graft_entry.py), on the CPU.

Two tests spawn processes: two gloo ranks that mirror
tests/test_distributed.py (the hybrid mesh's leading axis crosses the
processes, a global sum of 16) and hold `shard_train_step` against the
one-process step, with whole rows and with each rank's rows split over
two space slots, and the dry run, whose check 4 spawns two more.
"""

import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch import graft_entry as G
from image_segmenter_tpu_torch.models import u2net as U
from image_segmenter_tpu_torch.parallel import distributed as D
from image_segmenter_tpu_torch.parallel import mesh as TM
from image_segmenter_tpu_torch.pipeline import train as TR

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _f64_grads(rank: int, world: int):
    """Loss and gradients of `shard_train_step` over
    `hybrid_mesh((1, space), (world, 1))` for each space size of
    `G.RANK_SPACES` (a rank's share of the batch whole, and its rows over
    two slots of its process; Adam's first moment after one step is 0.1
    of the gradient) and, on rank 0, of the whole batch in one process,
    in float64 at 32 x 32, batch 4. A module cast by `.double()` computes
    in float64 (models/u2net.py)."""
    module = U.U2NET(small=True)
    tx, st = TR.create_train_state(module, seed=0, input_hw=(32, 32))
    module.double()
    params = {k: v.double() for k, v in st.params.items()}
    st = st._replace(params=params, opt_state=tx.init(params),
                     batch_stats={k: v.double()
                                  for k, v in st.batch_stats.items()})
    imgs, masks = (t.double() for t in G.train_batch(4, 32))
    step = TR.make_train_step(module, tx)
    runs = []
    for space in G.RANK_SPACES:
        mesh = D.hybrid_mesh((1, space), (world, 1), devices=[CPU] * space)
        new, loss = TR.shard_train_step(step, mesh)(st, imgs, masks)
        runs.append((loss, {k: m / 0.1
                            for k, m in new.opt_state["mu"].items()}))
    if rank != 0:
        return None
    loss_1, g_1, _ = TR.loss_and_grads(module, st, imgs, masks)
    out = []
    for loss, g in runs:
        out += [abs(float(loss) - float(loss_1)) / float(loss_1),
                max(float((g[k] - g_1[k]).norm() / g_1[k].norm())
                    for k in g if not k.endswith("conv_s1.bias"))]
    return out


def _rank(rank: int, world: int) -> dict:
    torch.set_num_threads(2)
    out = {"count": D.process_count(), "multi": D.is_multi_host(),
           "backend": torch.distributed.get_backend()}
    mesh = D.hybrid_mesh(ici_shape=(1, 4), dcn_shape=(2, 1),
                         devices=[CPU] * 4)
    out["shape"] = mesh.shape
    out["procs"] = mesh.processes.tolist()
    local = D.local_mesh(mesh)
    out["local"] = local.shape
    # a (2, 8) array of ones split (data, space): this process holds its
    # data row, split over its 4 slots; partials add on the first slot,
    # then across the processes
    x = torch.ones(2, 8)
    pieces = TM.batch_sharding(local).split(x[rank:rank + 1])
    part = sum(p.sum() for p in pieces[0])
    out["total"] = float(D.all_reduce_sum(part.reshape(1))[0])
    t = torch.tensor([rank + 1.0], requires_grad=True)
    s = D.all_reduce_sum_grad(2 * t)
    s.backward()
    out["grad_sum"] = (float(s.detach()), float(t.grad))
    out["train"] = G.train_rank(rank, world, "cpu", 4, 32, 1, 2)
    out["f64"] = _f64_grads(rank, world)
    return out


def test_two_process_gloo_group_and_sharded_train_step():
    res = D.run_ranks(_rank, 2, backend="gloo", timeout=300)
    for rank, r in enumerate(res):
        assert r["count"] == 2 and r["multi"] and r["backend"] == "gloo"
        assert r["shape"] == (2, 4) and r["local"] == (1, 4)
        procs = np.asarray(r["procs"])
        # the leading (data) axis is the cross-process one
        assert (procs[0] == procs[0, 0]).all()
        assert (procs[1] == procs[1, 0]).all()
        assert procs[0, 0] != procs[1, 0]
        assert r["total"] == 16.0
        assert r["grad_sum"] == (6.0, 4.0)
        assert set(r["train"]) == set(G.RANK_SPACES)
        for space, t in r["train"].items():
            assert t["loss"] == res[0]["train"][space]["loss"]
            assert len(t["slots"]) == space
    # whole rows (a slot a rank) and each rank's rows over 2 space slots
    for space, tr in res[0]["train"].items():
        print(space, {k: v for k, v in tr.items() if k not in ("ms", "ms_1")})
        assert tr["steps"] == 1 and np.isfinite(tr["loss"][0])
        assert tr["loss_gaps"][0] < 1e-4
        assert tr["held_maxdiff"] <= 1e-4
        assert tr["moved"] > 0
    # in float64 the sharded BatchNorm sums, loss and gradient sum are the
    # one-process step's to rounding: the float32 spread is the
    # cancellation of tiny BatchNorm sets, not the reduction
    loss_gap, grad_rel, loss_gap_sp, grad_rel_sp = res[0]["f64"]
    print(f"float64: loss gap {loss_gap:.2e}, worst gradient relative L2 "
          f"{grad_rel:.2e}; rows over 2 space slots a rank: "
          f"{loss_gap_sp:.2e}, {grad_rel_sp:.2e}")
    assert loss_gap < 1e-12 and grad_rel < 1e-9
    assert loss_gap_sp < 1e-12 and grad_rel_sp < 1e-9


def test_dryrun_multichip_on_the_cpu():
    """The dry run on 4 CPU slots: all five checks under their contracts."""
    line = G.dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: 4 slots on cpu, mesh dp=2 "
                           "sp=2")
    assert "2 gloo ranks" in line
    # check 4 on (world, 1) and (world, 2), and in one process on (1, 2)
    # and (2, 2)
    assert "2 gloo ranks x 1 space slot on cpu /" in line
    assert "2 gloo ranks x 2 space slots on cpu, cpu" in line
    assert "one process (1, 2) gap" in line and "(2, 2) gap" in line
    assert "staged==fused" in line


def test_single_process_helpers(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    D.initialize()  # nothing configured: nothing happens
    assert not torch.distributed.is_initialized()
    assert D.process_count() == 1 and not D.is_multi_host()
    with pytest.raises(ValueError, match="world_size and rank"):
        D.initialize(world_size=2)
    t = torch.ones(3)
    assert D.all_reduce_sum(t) is t and D.all_reduce_sum_grad(t) is t
    # one process: the hybrid mesh collapses to one contiguous mesh
    mesh = D.hybrid_mesh((1, 4), (2, 1), devices=[CPU] * 8)
    assert mesh.shape == (2, 4) and not mesh.processes.any()
    with pytest.raises(ValueError, match="needs 8 devices"):
        D.hybrid_mesh((1, 4), (2, 1), devices=[CPU] * 4)
    # one process and one slot: the step itself; more slots split the work
    step = TR.make_train_step(U.U2NET(small=True), TR.Adam())
    assert TR.shard_train_step(step, TM.make_mesh((1, 1), devices=[CPU])) \
        is step
    assert TR.shard_train_step(step, TM.make_mesh((2, 2), devices=[CPU] * 4)) \
        is not step


def test_default_backend(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.default_backend(2) == "gloo"  # two ranks would share the card
    assert D.default_backend(1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D.default_backend(4) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert D.default_backend(16) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert D.default_backend(1) == "gloo"


def test_initialize_reads_the_standard_variables(monkeypatch):
    """MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK become the arguments
    of init_process_group (recorded here, not called)."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D.initialize()
    assert seen == {"backend": "gloo", "init_method": "tcp://localhost:1234",
                    "world_size": 3, "rank": 2}


def test_entry_forward():
    """entry(): U^2-Netp's fused output at 320 x 320 from seeded weights,
    the same on a second call."""
    fn, args = G.entry(device="cpu")
    y = fn(*args)
    assert tuple(y.shape) == (1, 1, 320, 320) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and float(y.min()) >= 0.0
    fn2, args2 = G.entry(device="cpu")
    assert torch.equal(fn2(*args2), y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            G.entry()


def test_graft_entry_parses_its_arguments(monkeypatch):
    """python -m image_segmenter_tpu_torch.graft_entry N [--device D]:
    the parser alone (the run is test_dryrun_multichip_on_the_cpu)."""
    seen = {}
    monkeypatch.setattr(G, "dryrun_multichip",
                        lambda n, device: seen.update(n=n, dev=device))
    G.main(["3", "--device", "cpu"])
    assert seen == {"n": 3, "dev": "cpu"}
    G.main([])
    assert seen == {"n": 8, "dev": "cuda"}
