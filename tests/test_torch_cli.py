"""The PyTorch port's CLI (image_segmenter_tpu_torch/cli.py) against the JAX
package's, in-process on the CPU, and the port's PNG codec against PIL.

Both CLIs run on the 96 x 128 photo of tests/test_cli.py. The JAX CLI
writes its output with PIL, the port's with its own codec, so the outputs
are compared as decoded pixels (PIL reads both files), and the `--stats`
JSON field by field: `rgb_std` adds squares in float32 in XLA's order in
the JAX package and in float64 in the port, so it is held to 1e-6
relative as tests/test_torch_color_simplify.py holds it; every other field
is equal.
"""

import contextlib
import io
import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_segmenter_tpu import cli as JC
from image_segmenter_tpu.compat import rembg_infer as JRI
from image_segmenter_tpu_torch import cli as TC
from image_segmenter_tpu_torch.compat import rembg_infer as TRI
from image_segmenter_tpu_torch.models import registry as TREG
from image_segmenter_tpu_torch.models.convert import state_from_flax

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    rgb = np.clip(np.stack([
        127 + 90 * np.sin(xx / 17) * np.cos(yy / 13),
        127 + 90 * np.cos(xx / 23),
        127 + 90 * np.sin((xx + yy) / 31),
    ], -1) + rng.normal(0, 4, (96, 128, 3)), 0, 255).astype(np.uint8)
    p = d / "in.png"
    Image.fromarray(rgb).save(p)
    return p, d, rgb


def _main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue()


def _both(photo, flags, tag):
    src, d, _ = photo
    res = {}
    for name, mod, extra in (("jax", JC, []), ("port", TC, ["--device", "cpu"])):
        dst = d / f"{tag}_{name}.png"
        rc, stdout = _main(mod, [src, dst, *flags, *extra])
        assert rc == 0
        res[name] = (np.asarray(Image.open(dst).convert("RGBA")), stdout)
    return res


def _stats_json(stdout):
    return json.loads(stdout[stdout.index("{"):])


FLAG_SETS = {
    "kmeans_cleanup_trim": ["--colors", "6", "--algorithm", "kmeans",
                            "--cleanup", "--trim-tendrils", "2", "--stats",
                            "-q"],
    "palette": ["--palette", "ff0000,00ff00,0000ff", "-q"],
    "grabcut_majority": ["--grabcut-rect", "16,8,96,86", "--smooth",
                         "majority", "-q"],
}


@pytest.mark.parametrize("tag", sorted(FLAG_SETS))
def test_cli_matches_jax(photo, tag):
    """The same pixels as the JAX CLI, and for --stats the same JSON (all
    fields equal but rgb_std, within 1e-6 relative: see the module
    docstring)."""
    res = _both(photo, FLAG_SETS[tag], tag)
    (j_px, j_out), (t_px, t_out) = res["jax"], res["port"]
    assert t_px.shape == (96, 128, 4) and t_px.dtype == np.uint8
    np.testing.assert_array_equal(t_px, j_px)
    if "--stats" not in FLAG_SETS[tag]:
        assert t_out == j_out == ""
        return
    j, t = _stats_json(j_out), _stats_json(t_out)
    assert t["regions"] == j["regions"]
    assert list(t["color"]) == list(j["color"])
    for k in t["color"]:
        if k == "rgb_std":
            np.testing.assert_allclose(t["color"][k], j["color"][k], rtol=1e-6)
        else:
            assert t["color"][k] == j["color"][k], k


def test_cli_rembg_contract_and_agreement(photo, monkeypatch):
    """--rembg with u2netp and the JAX session's seeded weights in the
    port's session: the colour channels are the input's, alpha is in
    {0, 255}, and it agrees with the JAX CLI's on >= 0.99 of the pixels
    (bytes are not expected to match: the bf16 convolutions of oneDNN and
    XLA round differently)."""
    js = JRI._get_session("u2netp")
    ts = TREG.Session("u2netp", device="cpu")
    ts.load_state_dict(state_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(js.variables))))
    monkeypatch.setitem(TRI._sessions, ("u2netp", "cpu"), ts)
    res = _both(photo, ["--rembg", "--model", "u2netp", "--no-simplify",
                        "-q"], "rembg")
    (j_px, _), (t_px, _) = res["jax"], res["port"]
    rgb = photo[2]
    np.testing.assert_array_equal(t_px[..., :3], rgb)
    assert set(np.unique(t_px[..., 3])) <= {0, 255}
    assert (t_px[..., 3] == j_px[..., 3]).mean() >= 0.99


def _options(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_OPTIONS = sorted(_options(JC.build_parser()))


@pytest.mark.parametrize("dest", JAX_OPTIONS)
def test_parser_option_matches_jax(dest):
    """Every option of the JAX parser with the same flags, default,
    choices, type, count and action."""
    j = _options(JC.build_parser())[dest]
    t = _options(TC.build_parser()).get(dest)
    assert t is not None, dest
    for attr in ("option_strings", "default", "choices", "type", "nargs",
                 "const", "required", "metavar"):
        assert getattr(t, attr) == getattr(j, attr), (dest, attr)
    assert type(t) is type(j)


def test_parser_adds_only_device():
    """The port's parser is the JAX one plus --device {cuda, cpu}, default
    cuda."""
    t = _options(TC.build_parser())
    assert set(t) - set(JAX_OPTIONS) == {"device"}
    assert t["device"].option_strings == ["--device"]
    assert t["device"].default == "cuda"
    assert t["device"].choices == ["cuda", "cpu"]


@pytest.mark.parametrize("argv", [["--algorithm", "nope"],
                                  ["--device", "tpu"],
                                  ["--connectivity", "6"]])
def test_cli_rejects_bad_options(photo, argv):
    src, d, _ = photo
    args = [str(src), str(d / "x.png"), *argv]
    if "--device" not in argv:
        args += ["--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        TC.main(args)
    assert e.value.code != 0


def test_cli_needs_a_card_unless_told_cpu(photo):
    """The default device is the card: without one the CLI raises before
    it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    src, d, _ = photo
    dst = d / "never.png"
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.main([str(src), str(dst), "--no-simplify"])
    assert not dst.exists()


# ---------------------------------------------------------------------------
# the PNG codec
# ---------------------------------------------------------------------------

def _image(mode, h=13, w=17, seed=0):
    rng = np.random.default_rng(seed)
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    a[:4] = a[:1]  # runs that PIL's filters like
    return a[..., 0] if c == 1 else a


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_codec_decodes_pil_files(tmp_path, mode):
    """PNGs written by PIL (its own filter choice, several IDAT chunks on
    a larger image) decode to PIL's RGBA."""
    for hw in ((13, 17), (300, 211)):
        p = tmp_path / f"{mode}_{hw[0]}.png"
        Image.fromarray(_image(mode, *hw), mode).save(p)
        want = np.asarray(Image.open(p).convert("RGBA"))
        np.testing.assert_array_equal(TC._load_rgba(str(p)), want)


@pytest.mark.parametrize("channels", [3, 4])
def test_pil_decodes_codec_files(tmp_path, channels):
    """The codec's RGB and RGBA files read back through PIL as written;
    `_save` writes RGBA."""
    px = _image("RGBA")[..., :channels].copy()
    p = tmp_path / "c.png"
    p.write_bytes(TC._png_encode(px))
    img = Image.open(p)
    assert img.mode == ("RGB" if channels == 3 else "RGBA")
    np.testing.assert_array_equal(np.asarray(img), px)
    TC._save(str(p), _image("RGBA"))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), _image("RGBA"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(px, kinds):
    """Hand-built PNG rows: row y filtered with kinds[y], by the spec's
    definitions, one byte at a time."""
    h, w, c = px.shape
    raw = px.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind, line = kinds[y], []
        for i in range(w * c):
            a = raw[y, i - c] if i >= c else 0
            b = raw[y - 1, i] if y else 0
            cc = raw[y - 1, i - c] if (y and i >= c) else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][kind]
            line.append((raw[y, i] - pred) % 256)
        out.append(bytes([kind]) + bytes(line))
    return b"".join(out)


def _png(px, kinds, chunks=1):
    h, w, c = px.shape
    data = zlib.compress(_filter_rows(px, kinds))
    step = -(-len(data) // chunks)
    body = [TC._png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0))]
    body += [TC._png_chunk(b"IDAT", data[i:i + step])
             for i in range(0, len(data), step)]
    return TC._PNG_SIGNATURE + b"".join(body) + TC._png_chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_codec_decodes_each_filter(tmp_path, kind, channels):
    """Every row filtered with one of the five filter types (the first row
    has no row above, the first pixel no left neighbour), split over three
    IDAT chunks: the codec and PIL decode the same RGBA."""
    px = _image("RGBA", 9, 11, seed=kind)[..., :channels].copy()
    data = _png(px, [kind] * px.shape[0], chunks=3)
    p = tmp_path / "f.png"
    p.write_bytes(data)
    got = TC._png_decode(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGBA")))
    rgb = px if channels >= 3 else np.repeat(px, 3, axis=2)
    np.testing.assert_array_equal(got[..., :3], rgb[..., :3])


def test_codec_decodes_mixed_filters(tmp_path):
    px = _image("RGBA", 10, 6, seed=9)
    data = _png(px, [4, 3, 1, 2, 0, 4, 4, 3, 2, 1])
    np.testing.assert_array_equal(TC._png_decode(data), px)


@pytest.mark.parametrize("what", ["16-bit", "palette", "interlaced", "crc",
                                  "trns", "signature"])
def test_codec_refuses_what_it_does_not_read(what):
    """A PNG the codec does not handle raises ValueError naming why."""
    px = _image("RGB", 4, 5)
    data = bytearray(_png(px, [0] * 4))
    if what == "signature":
        data[1] = ord("X")
    elif what == "crc":
        data[-5] ^= 1  # IEND's CRC
    elif what == "trns":
        end = len(data) - 12
        data[end:end] = TC._png_chunk(b"tRNS", b"\x00\x01\x00\x02\x00\x03")
    else:
        off = 8 + 8  # IHDR's body
        if what == "16-bit":
            data[off + 8] = 16
        elif what == "palette":
            data[off + 9] = 3
        else:
            data[off + 12] = 1
        body = bytes(data[off:off + 13])
        data[off + 13:off + 17] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    with pytest.raises(ValueError):
        TC._png_decode(bytes(data))


def test_other_formats_need_pil(tmp_path, monkeypatch):
    """Without Pillow, .png still reads and writes and another format
    raises an error that names the file and Pillow."""
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    px = _image("RGBA")
    TC._save(str(tmp_path / "ok.png"), px)
    np.testing.assert_array_equal(TC._load_rgba(str(tmp_path / "ok.png")), px)
    for path in (tmp_path / "x.bmp", tmp_path / "x.jpg"):
        with pytest.raises(RuntimeError, match="Pillow"):
            TC._save(str(path), px)
    with pytest.raises(RuntimeError, match="x.tiff.*Pillow"):
        TC._load_rgba(str(tmp_path / "x.tiff"))


def test_cli_subprocess_entry(photo):
    """`python -m image_segmenter_tpu_torch.cli` is the same program as
    the in-process main."""
    import subprocess
    import sys

    src, d, _ = photo
    flags = ["--palette", "ff0000,00ff00,0000ff", "-q", "--device", "cpu"]
    TC.main([str(src), str(d / "inproc.png"), *flags])
    r = subprocess.run([sys.executable, "-m", "image_segmenter_tpu_torch.cli",
                        str(src), str(d / "sub.png"), *flags],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (d / "sub.png").read_bytes() == (d / "inproc.png").read_bytes()
