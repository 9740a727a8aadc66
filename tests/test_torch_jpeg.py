"""The port's JPEG decoder (utils/images.py::read_jpeg) against imageio.

imageio reads JPEG through PIL's libjpeg-turbo with libjpeg's defaults
(islow IDCT, fancy chroma upsampling, the fixed-point YCbCr tables),
which the decoder reproduces: the tolerance is 0, equal bits, on the
committed fixtures (data/jpeg/: pixels stored as imageio gave them) and
on files written here with PIL at several qualities and subsamplings,
baseline and progressive, with and without restart markers. The PIL
cases skip where PIL or imageio is missing (as on the card's machine);
the committed fixtures run everywhere.
"""

import glob
import io
import json
import os
import sys

import numpy as np
import pytest

from nerf_from_image_tpu_torch.data.jpeg import FIXTURE_DIR
from nerf_from_image_tpu_torch.data.jpeg.make_fixtures import (
    CAM_FRONT_FRAME,
    pixel_digest,
    pattern_image,
)
from nerf_from_image_tpu_torch.utils import images
from tests.test_torch_generator import release_memory  # noqa: F401

MAX_LEVEL_DIFF = 0  # of 255: the decoder meets imageio bit for bit

SMALL_FIXTURES = sorted(os.path.basename(p)[:-4]
                        for p in glob.glob(os.path.join(FIXTURE_DIR, "*.npy")))


def _max_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_fixture_set_is_complete():
    assert SMALL_FIXTURES == ["baseline_420", "baseline_422", "baseline_444", "grey",
                              "progressive_420", "restart_420"]


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_committed_fixture_matches_imageio(name):
    got = images.read_jpeg(os.path.join(FIXTURE_DIR, name + ".jpg"))
    assert _max_diff(got, np.load(os.path.join(FIXTURE_DIR, name + ".npy"))) <= MAX_LEVEL_DIFF


def test_committed_cam_front_frame_matches_imageio():
    """The 1600x900 4:2:0 frame: imageio's pixels are kept as a digest."""
    got = images.read_jpeg(os.path.join(FIXTURE_DIR, CAM_FRONT_FRAME))
    with open(os.path.join(FIXTURE_DIR, "CAM_FRONT_FRAME.json")) as f:
        assert pixel_digest(got) == json.load(f)


PIL_CASES = [
    # (shape, quality, subsampling, progressive, restart blocks)
    ((37, 53, 3), 30, 2, False, 0),
    ((37, 53, 3), 95, 1, True, 0),
    ((40, 17, 3), 75, 0, True, 2),
    ((17, 3, 3), 90, 2, True, 0),  # chroma two samples wide: replicated
    ((2, 9, 3), 50, 1, False, 1),
    ((33, 31), 60, 0, True, 0),
]


@pytest.mark.parametrize("shape,quality,subsampling,progressive,restart", PIL_CASES)
def test_pil_written_file_matches_imageio(shape, quality, subsampling, progressive, restart,
                                          tmp_path):
    pil = pytest.importorskip("PIL.Image")
    imageio = pytest.importorskip("imageio.v2")
    options = {"quality": quality, "progressive": progressive}
    if len(shape) == 3:
        options["subsampling"] = subsampling
    if restart:
        options["restart_marker_blocks"] = restart
    path = str(tmp_path / "x.jpg")
    pil.fromarray(pattern_image(shape, quality)).save(path, "JPEG", **options)
    with open(path, "rb") as f:
        assert (b"\xff\xdd" in f.read()) == bool(restart)
    assert _max_diff(images.read_jpeg(path), np.asarray(imageio.imread(path))) <= MAX_LEVEL_DIFF


def test_read_image_decodes_jpeg_without_imageio(monkeypatch):
    for name in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    got = images.read_image(os.path.join(FIXTURE_DIR, "baseline_420.jpg"))
    np.testing.assert_array_equal(got, np.load(os.path.join(FIXTURE_DIR, "baseline_420.npy")))


@pytest.mark.parametrize("sof,precision,match", [
    (0xC9, 8, "arithmetic"), (0xC0, 12, "12-bit"), (0xC3, 8, "lossless")])
def test_out_of_scope_files_raise(sof, precision, match, tmp_path):
    """Arithmetic coding, 12-bit samples and lossless files raise
    UnsupportedImage (read_image then hands them to imageio)."""
    with open(os.path.join(FIXTURE_DIR, "baseline_444.jpg"), "rb") as f:
        data = bytearray(f.read())
    at = data.index(b"\xff\xc0")
    data[at + 1] = sof
    data[at + 4] = precision
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(images.UnsupportedImage, match=match):
        images.read_jpeg(path)


def test_truncated_file_raises(tmp_path):
    with open(os.path.join(FIXTURE_DIR, "baseline_420.jpg"), "rb") as f:
        data = f.read()
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        images.read_jpeg(path)
