"""The matting CG's fused update (kernels/cg_update.py) on the CPU.

Which path `CGLoop` takes from its input (the CPU, float64 and a split
solve run `_body`), the wrappers' checks, the kernels' grid and the
micro's bounds. The kernels have no CPU version: `CGLoop._step_fused` is
held to `_body` bit for bit, chunk by chunk, on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.kernels import cg_update as CU
from image_segmenter_tpu_torch.parallel import mesh as TM
from image_segmenter_tpu_torch.solvers import matting as TMAT
from test_torch_loops import _image, _trimap_x0

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("devices,dtype,want", [
    (["cuda"], torch.float32, "fused"),
    ([torch.device("cuda", 0)], torch.float32, "fused"),
    (["cpu"], torch.float32, "plain"),
    (["cuda"], torch.float64, "plain"),
    (["cpu"], torch.float64, "plain"),
    (["cuda:0", "cuda:1"], torch.float32, "plain"),
    (["cuda:0", "cuda:0"], torch.float32, "plain"),
])
def test_update_path_from_device_type_and_blocks(devices, dtype, want):
    assert TMAT.update_path(devices, dtype) == want


def _inputs(b, h=37, w=53, seed=13):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(_image(rng, h, w, b=b))
    tri, x0 = (torch.from_numpy(a) for a in _trimap_x0(rng, b, h, w))
    return img, tri, x0


@pytest.mark.parametrize("case", ["f32", "f64", "split"])
def test_cg_loop_runs_body_on_the_cpu(case):
    """The CPU, the float64 rungs and a solve split over two slots take
    `_body`: the fused step's buffers are never made."""
    img, tri, x0 = _inputs(2)
    mesh = None
    if case == "f64":
        img, tri, x0 = img.double(), tri.double(), None
    elif case == "split":
        mesh = TM.make_mesh((1, 2), devices=[CPU] * 2)
    loop = TMAT.CGLoop(img, tri, rtol=1e-4, max_iter=50, x0=x0,
                       half_stats=case != "f64", mesh=mesh)
    assert loop.update == "plain"
    loop.run()
    assert loop._fused is None and not bool(loop.flag)


@pytest.mark.parametrize("kernel", ["cg_dot", "cg_advance",
                                    "cg_direction"])
def test_kernels_take_card_tensors_only(kernel, monkeypatch):
    """The CPU runs `_body`, the kernels' plain version: a wrapper given
    CPU fields raises before it builds or launches anything."""
    monkeypatch.setattr(CU._build, "library", lambda: pytest.fail("built"))
    b, h, w = 2, 5, 7
    f = torch.zeros((b, h, w))
    part = CU.partials(b, h * w, CPU)
    st = CU.State(torch.ones(b), torch.zeros(b, dtype=torch.bool),
                  torch.zeros(b, dtype=torch.int32),
                  torch.ones(b, dtype=torch.bool))
    call = {"cg_dot": lambda: CU.cg_dot(f, f, f, f, st.active, 1.0, part),
            "cg_advance": lambda: CU.cg_advance(f, f, f, f, f, f, part, st,
                                                part),
            "cg_direction": lambda: CU.cg_direction(
                f, f, f, f, f, part, part, st, st, torch.ones(b), 1e-4, 10)}
    launches = CU.LAUNCHES
    with pytest.raises(ValueError, match="on the card"):
        call[kernel]()
    assert CU.LAUNCHES == launches


def test_partials_and_blocks():
    """A block of each kernel covers TILE pixels and writes two float64
    partials an image."""
    assert CU.TILE == CU.THREADS * CU.ITEMS == 1024
    assert CU.blocks(576 * 1024) == 576 and CU.blocks(1) == 1
    assert CU.blocks(CU.TILE + 1) == 2
    part = CU.partials(3, 576 * 1024, "cpu")
    assert part.shape == (3, 576, 2) and part.dtype == torch.float64


def test_micro_bounds_and_no_card(monkeypatch):
    """bench/micro_cg_iter.py's bounds: 17 planes an iteration outside K3
    (16.875 with the chunk's last iteration writing no q) at 4 x 576 x
    1024 move 160.4 MB, 47.9 us at 3.35 TB/s; without a card it raises."""
    from image_segmenter_tpu_torch.bench import micro_cg_iter as MC

    px = 4 * 576 * 1024
    assert MC.bound_ms(17, px) == pytest.approx(17 * 4 * px / 3.35e9)
    assert MC.bound_ms(17, px) == pytest.approx(0.04789, abs=1e-5)
    outside = sum(v for k, v in MC.PLANES.items() if k != "matvec_kernel")
    assert outside == pytest.approx(17 - 1 / TMAT.CG_CHUNK)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        MC.main(["1", "8", "8"])
