"""ISNet, the ONNX loader and checkpoint discovery of the PyTorch port.

ISNet is held to the JAX package's Flax module on the same weights (the
Flax variables carried over by models/convert.py) at float32, where the
two differ only by convolution summation order: 1e-4 absolute on the
sigmoid outputs. No rembg checkpoint is in the repository, so the loader
is tested on files the port's own writer makes from seeded weights, and
on one the JAX package's writer makes.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.models import onnx_writer as JOW
from image_segmenter_tpu.models import u2net as JU
from image_segmenter_tpu_torch.models import onnx_import as OIMP
from image_segmenter_tpu_torch.models import onnx_writer as OW
from image_segmenter_tpu_torch.models import registry as TR
from image_segmenter_tpu_torch.models import u2net as TU
from image_segmenter_tpu_torch.models.convert import state_from_flax
from image_segmenter_tpu_torch.tools import verify_checkpoint as VC

torch.set_num_threads(2)


def test_isnet_f32_matches_flax():
    """conv_in (stride 2, no BN), the full encoder-decoder, six side heads
    upsampled to the input: 1e-4 absolute at half=False."""
    jm = JU.ISNet(half=False)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tm = TU.ISNet(half=False).eval()
    state = state_from_flax(jax.tree_util.tree_map(np.asarray, v))
    assert "conv_in.weight" in state and "side6.bias" in state
    tm.load_state_dict(state)  # strict: every leaf carried over
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)) \
        .astype(np.float32)
    jo = [np.asarray(o) for o in jax.jit(jm.apply)(v, x)]
    with torch.no_grad():
        to = [o.permute(0, 2, 3, 1).numpy()
              for o in tm(torch.from_numpy(x).permute(0, 3, 1, 2))]
    assert len(jo) == len(to) == 6
    for a, b in zip(jo, to):
        assert a.shape == b.shape == (1, 64, 64, 1)
        assert np.abs(a - b).max() <= 1e-4


@pytest.fixture(scope="module")
def u2netp_state():
    """A seeded U2NETP state with non-trivial BatchNorm statistics, so a
    mapping mistake cannot hide behind identity BN."""
    sess = TR.Session("u2netp", half=False, seed=5, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in sess.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=g)
                m.running_var.uniform_(0.6, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return {k: v.clone() for k, v in sess.module.state_dict().items()}


def _fresh_u2netp():
    return TR._build(TR.SPECS["u2netp"], half=False)


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("positional", [False, True])
def test_onnx_round_trip(u2netp_state, tmp_path, positional):
    """Named initializers map directly; stripped names fall back to the
    graph order and give the same state."""
    path = str(tmp_path / "u2netp.onnx")
    OW.export_torch_state(path, u2netp_state, positional=positional)
    state, report = OIMP.load_into_state_dict(_fresh_u2netp(), path)
    assert report.complete and report.total > 200
    assert report.mode == ("graph-order" if positional else "named")
    _assert_state_equal(state, u2netp_state)


def test_onnx_from_the_jax_writer_loads(u2netp_state, tmp_path):
    """A file the JAX package's writer makes reads the same."""
    path = str(tmp_path / "u2netp.onnx")
    JOW.export_torch_state(path, {k: v.numpy() for k, v in u2netp_state.items()
                                  if "num_batches" not in k})
    state, report = OIMP.load_into_state_dict(_fresh_u2netp(), path)
    assert report.complete and report.mode == "named"
    _assert_state_equal(state, u2netp_state)


def test_partial_checkpoint_refused(u2netp_state, tmp_path):
    broken = dict(u2netp_state)
    broken.pop("stage3.rebnconv2.conv_s1.weight")
    broken.pop("stage3.rebnconv2.conv_s1.bias")
    path = str(tmp_path / "partial.onnx")
    OW.export_torch_state(path, broken)
    with pytest.raises(RuntimeError, match="incomplete"):
        OIMP.load_into_state_dict(_fresh_u2netp(), path, strict=True)
    with pytest.raises(RuntimeError, match="incomplete"):
        TR.Session("u2netp", device="cpu", ckpt_path=path)
    _, report = OIMP.load_into_state_dict(_fresh_u2netp(), path, strict=False)
    assert not report.complete
    assert any("stage3" in m for m in report.missing)


def test_shape_mismatch_refused(u2netp_state, tmp_path):
    wrong = dict(u2netp_state)
    wrong["stage1.rebnconvin.conv_s1.weight"] = torch.zeros((64, 4, 3, 3))
    path = str(tmp_path / "wrong.onnx")
    OW.export_torch_state(path, wrong)
    with pytest.raises(RuntimeError, match="incomplete"):
        OIMP.load_into_state_dict(_fresh_u2netp(), path)
    _, report = OIMP.load_into_state_dict(_fresh_u2netp(), path, strict=False)
    assert report.shape_mismatch and "stage1.rebnconvin" in report.shape_mismatch[0]


def test_folded_bn_export_accepted(u2netp_state, tmp_path):
    """An export with BN folded into the convs has no BN initializers; the
    module's identity BN is then right and the load is complete."""
    folded = {k: v for k, v in u2netp_state.items() if ".bn_s1." not in k}
    path = str(tmp_path / "folded.onnx")
    OW.export_torch_state(path, folded)
    module = _fresh_u2netp()
    state, report = OIMP.load_into_state_dict(module, path)
    assert report.complete and report.folded_bn > 0
    assert torch.equal(state["stage1.rebnconvin.bn_s1.running_var"],
                       module.state_dict()["stage1.rebnconvin.bn_s1.running_var"])
    assert torch.equal(state["side1.weight"], u2netp_state["side1.weight"])


def test_isnet_checkpoint_round_trip(tmp_path):
    """The seeded ISNet written to .onnx loads completely into a session
    of another seed and gives the seeded session's weights."""
    seeded = TR.Session("isnet-general-use", half=False, device="cpu", seed=0)
    path = str(tmp_path / "isnet-general-use.onnx")
    OW.export_torch_state(path, seeded.module.state_dict())
    loaded = TR.Session("isnet-general-use", half=False, device="cpu", seed=9,
                        ckpt_path=path)
    assert loaded.weights_loaded and loaded.load_report.complete
    assert loaded.load_report.mapped == loaded.load_report.total
    assert not seeded.weights_loaded and seeded.load_report is None
    _assert_state_equal(loaded.module.state_dict(), seeded.module.state_dict())
    order = OIMP.call_order(seeded.module.state_dict())
    assert order[0] == ("conv", "conv_in") and order[-1] == ("conv", "side6")


def test_u2net_home_discovery(u2netp_state, tmp_path, monkeypatch):
    OW.export_torch_state(str(tmp_path / "u2netp.onnx"), u2netp_state)
    monkeypatch.setenv("U2NET_HOME", str(tmp_path))
    assert TR._checkpoint_path("u2netp") == str(tmp_path / "u2netp.onnx")
    assert TR._checkpoint_path("u2net") is None
    sess = TR.Session("u2netp", half=False, device="cpu")
    assert sess.weights_loaded and sess.load_report.complete
    _assert_state_equal(sess.module.state_dict(), u2netp_state)
    monkeypatch.delenv("U2NET_HOME")
    monkeypatch.setenv("HOME", str(tmp_path))
    os.makedirs(tmp_path / ".u2net")
    OW.export_torch_state(str(tmp_path / ".u2net" / "u2netp.onnx"),
                          u2netp_state)
    assert TR._checkpoint_path("u2netp") == str(tmp_path / ".u2net" /
                                                "u2netp.onnx")


def test_verify_checkpoint_drill(u2netp_state, tmp_path, capsys):
    path = str(tmp_path / "u2netp.onnx")
    OW.export_torch_state(path, u2netp_state)
    out = tmp_path / "report.json"
    rc = VC.main([path, "--device", "cpu", "--json", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == json.loads(out.read_text())
    assert printed["model"] == "u2netp" and printed["load"]["ok"]
    assert printed["load"]["mapped"] == printed["load"]["total"] > 200
    assert len(printed["activations"]) == 7
    for st in printed["activations"]:
        assert np.isfinite([st["mean"], st["std"], st["min"], st["max"]]).all()
    m = printed["mask"]
    assert 0.0 <= m["fg_frac_at_128"] <= 1.0
    assert 0.0 <= m["sharp_fg_frac"] <= 1.0
    assert 0 <= m["otsu_threshold"] <= 255


def test_verify_checkpoint_refuses_partial(u2netp_state, tmp_path, capsys):
    state = dict(u2netp_state)
    state.pop("stage3.rebnconv2.conv_s1.weight")
    path = str(tmp_path / "u2netp.onnx")
    OW.export_torch_state(path, state)
    result = VC.verify(path, device="cpu")
    assert not result["load"]["ok"]
    assert result["load"]["mapped"] < result["load"]["total"]
    assert any("stage3" in m for m in result["load"]["missing"])
    assert "mask" not in result
    assert VC.main([path, "--device", "cpu"]) == 1
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.raises(SystemExit):
        VC.verify(str(tmp_path / "not_a_model.onnx"), device="cpu")
