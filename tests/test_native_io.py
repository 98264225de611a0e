"""Native .flo I/O + prefetching loader."""
import os

import numpy as np
import pytest

from optical_flow_tpu.io.flo import read_flo, write_flo
from optical_flow_tpu.native.build import load_floio


def test_native_lib_builds():
    lib = load_floio()
    if lib is None:
        pytest.skip("no C toolchain available")
    assert hasattr(lib, "flo_read") and hasattr(lib, "flo_write")


def test_native_roundtrip_matches_numpy(tmp_path, rng):
    flow = rng.standard_normal((23, 31, 2)).astype(np.float32)
    p1 = os.path.join(tmp_path, "a.flo")
    write_flo(flow, p1)  # native when available
    back = read_flo(p1)
    np.testing.assert_array_equal(back, flow)

    # cross-check against a hand-written numpy .flo file
    p2 = os.path.join(tmp_path, "b.flo")
    with open(p2, "wb") as f:
        np.array([202021.25], dtype=np.float32).tofile(f)
        np.array([31, 23], dtype=np.int32).tofile(f)
        flow.tofile(f)
    np.testing.assert_array_equal(read_flo(p2), flow)


def test_native_invalid_magic(tmp_path):
    p = os.path.join(tmp_path, "bad.flo")
    with open(p, "wb") as f:
        np.array([1.0], dtype=np.float32).tofile(f)
        np.array([4, 4], dtype=np.int32).tofile(f)
        np.zeros(32, dtype=np.float32).tofile(f)
    with pytest.raises(ValueError):
        read_flo(p)


def test_native_missing_file(tmp_path):
    with pytest.raises((FileNotFoundError, OSError)):
        read_flo(os.path.join(tmp_path, "nope.flo"))


def test_png_decoder_matches_pil_on_dataset(data_dir):
    """Native C PNG decode == PIL, byte-exact, on every vendored sequence."""
    import glob

    from PIL import Image

    from optical_flow_tpu.io.png import read_png
    from optical_flow_tpu.native.build import load_pngdec

    if load_pngdec() is None:
        pytest.skip("no C toolchain available")
    paths = sorted(glob.glob(os.path.join(data_dir, "other-data", "*", "frame10.png")))
    assert len(paths) >= 8
    for p in paths:
        ours = read_png(p)
        pil = np.array(Image.open(p))
        np.testing.assert_array_equal(ours, pil)


def test_png_python_fallback_on_dataset(data_dir, monkeypatch):
    """With the native decoder and PIL both unavailable, the numpy + zlib
    fallback decodes a dataset frame to the same bytes as the C decoder."""
    import sys

    from optical_flow_tpu.io import png

    p = os.path.join(data_dir, "other-data", "RubberWhale", "frame10.png")
    with open(p, "rb") as f:
        assert f.read(8) == png._PNG_SIG
    monkeypatch.setattr(png, "_native", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = png.read_png(p)
    assert out.shape == (388, 584, 3) and out.dtype == np.uint8
    monkeypatch.undo()
    np.testing.assert_array_equal(out, png.read_png(p))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P"])
def test_png_decoder_modes(tmp_path, rng, mode):
    """All supported color types decode byte-exactly (palette expands to RGB)."""
    from PIL import Image

    from optical_flow_tpu.io.png import read_png
    from optical_flow_tpu.native.build import load_pngdec

    if load_pngdec() is None:
        pytest.skip("no C toolchain available")
    # structured data exercises every scanline filter the encoder picks
    h, w = 37, 53
    base = (
        np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256
        + rng.integers(0, 8, (h, w))
    ).astype(np.uint8)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    arr = np.stack([np.roll(base, i, axis=1) for i in range(ch)], axis=-1).squeeze()
    if mode == "P":
        im = Image.fromarray(arr, "L").convert("P", palette=Image.ADAPTIVE)
    else:
        im = Image.fromarray(arr, mode)
    p = os.path.join(tmp_path, f"x_{mode}.png")
    im.save(p)
    ours = read_png(p)
    pil = np.array(im.convert("RGB")) if mode == "P" else np.array(Image.open(p))
    np.testing.assert_array_equal(ours, pil)


def test_png_decoder_unsupported_falls_back(tmp_path, rng):
    """16-bit PNGs exceed the C subset: read_png must fall back to PIL."""
    from PIL import Image

    from optical_flow_tpu.io.png import read_png

    arr = rng.integers(0, 65535, (9, 11)).astype(np.uint16)
    p = os.path.join(tmp_path, "deep.png")
    Image.fromarray(arr).save(p)
    out = read_png(p)
    np.testing.assert_array_equal(out, np.array(Image.open(p)))


def test_png_decoder_missing_file(tmp_path):
    from optical_flow_tpu.io.png import read_png

    with pytest.raises((FileNotFoundError, OSError)):
        read_png(os.path.join(tmp_path, "nope.png"))


def test_prefetch_loader(data_dir):
    from optical_flow_tpu.io.loader import middlebury_loader

    loader = middlebury_loader(["RubberWhale", "Dimetrodon"], data_dir)
    got = list(loader)
    assert len(got) == 2
    for im1, im2, tu, tv in got:
        assert im1.shape == im2.shape
        assert tu is not None
