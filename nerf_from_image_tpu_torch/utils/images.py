"""Host-side image files: PNG read and write, demo composites.

The reference saves demo composites with torchvision save_image(nrow=1)
over horizontally pre-concatenated panels (reference: run.py:2144-2159,
demo_nusc.py side-by-side outputs); here a grid is assembled in numpy and
written as an 8-bit PNG by the standard library (zlib and struct), so a
machine without imageio or PIL writes it too. This package's copy of the
JAX package's utils/images.py: the same pixels as its imageio file.

The data layer reads images with `read_image`: PNG files (8- and 16-bit
gray, gray+alpha, RGB and RGBA, every row filter, no interlace) are
decoded here with zlib and numpy, the pixels imageio gives; anything else
(JPG, palette or interlaced PNG) goes through imageio, and raises naming
the file where imageio is missing.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (3, palette, is left to imageio).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedImage(ValueError):
    """A file that this module does not decode (not a PNG, or a PNG
    with a palette, interlace or a bit depth under 8)."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """Writes a uint8 image, [H, W] or [H, W, 1] gray or [H, W, 3] RGB, as
    an 8-bit PNG (no interlace, filter 0 on every row)."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected [H, W] or [H, W, 3] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.concatenate((np.zeros((h, 1), np.uint8), img.reshape(h, -1)), axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _png_chunks(path: str, data: bytes):
    """(IHDR fields, the IDAT payload) of a PNG file's bytes."""
    if not data.startswith(_PNG_SIGNATURE):
        raise UnsupportedImage(f"{path} is not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return header, b"".join(idat)


def _unfilter_rows(kinds: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undoes PNG row filters None, Sub and Up ([H] kinds 0-2; [H, stride]
    filtered bytes; bpp bytes a pixel), all rows at once: Sub is a running
    sum along the row mod 256, Up one down each run of Up rows."""
    out = filt.copy()
    sub = kinds == 1
    if sub.any():
        lanes = filt[sub].reshape(int(sub.sum()), -1, bpp)
        out[sub] = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(lanes.shape[0], -1)
    up = kinds == 2
    if up.any():
        # recon[r] = recon[b] + filt[b+1] + ... + filt[r], b the last row
        # above r that is not Up (a zero row before the image).
        rows = np.arange(len(kinds))
        base = np.maximum.accumulate(np.where(up, -1, rows))[up] + 1
        total = np.cumsum(filt, axis=0, dtype=np.uint8)
        zero = np.zeros_like(filt[:1])
        out[up] = (np.concatenate((zero, out))[base] + total[up]
                   - np.concatenate((zero, total))[base])
    return out


def _unfilter_diagonals(kinds: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undoes all five PNG row filters. Average and Paeth take the pixel to
    the left, above and above-left, so pixel (r, x) goes in column r + x of
    a skewed array: one column is one anti-diagonal, decoded at once from
    the two columns before it, for H + W - 1 numpy steps."""
    h = len(kinds)
    w = filt.shape[1] // bpp
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    skew = rows + cols + 2  # two zero columns before the first pixel
    f = np.zeros((h, h + w + 1, bpp), np.int16)
    f[rows, skew] = filt.reshape(h, w, bpp)
    s = np.zeros((h + 1, h + w + 1, bpp), np.int16)  # row 0: the zero row above
    kind = [(kinds == k)[:, None] for k in range(1, 5)]
    for t in range(2, h + w + 1):
        lo, hi = max(0, t - 1 - w), min(h, t - 1)  # the rows this diagonal crosses
        a, b, c = s[lo + 1:hi + 1, t - 1], s[lo:hi, t - 1], s[lo:hi, t - 2]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        sub, up, avg, pae = (k[lo:hi] for k in kind)
        pred = np.where(sub, a, np.where(up, b, np.where(
            avg, (a + b) >> 1, np.where(pae, paeth, 0))))
        s[lo + 1:hi + 1, t] = (f[lo:hi, t] + pred) & 255
    return s[1:][rows, skew].astype(np.uint8).reshape(h, -1)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced PNG of bit depth 8 or 16 without a palette -> the
    array imageio.v2.imread gives: [H, W] for gray, else [H, W, C] (2
    gray+alpha, 3 RGB, 4 RGBA), uint8 or uint16. Raises UnsupportedImage
    for any other file."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, color, _, _, interlace), idat = _png_chunks(path, data)
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise UnsupportedImage(f"{path}: PNG of colour type {color}, bit depth {depth}, "
                               f"interlace {interlace}")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size != h * (1 + bpp * w):
        raise ValueError(f"{path}: {rows.size} bytes of pixels for {h}x{w}")
    rows = rows.reshape(h, 1 + bpp * w)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {kinds.max()}")
    if (kinds >= 3).any():
        pixels = _unfilter_diagonals(kinds, filt, bpp)
    else:
        pixels = _unfilter_rows(kinds, filt, bpp)
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = pixels.reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels


def _imageio_imread(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"{path}: this package decodes PNG only (8- or 16-bit, no "
                          "palette or interlace); other images need imageio, which is "
                          "not installed") from e
    return np.asarray(imageio.imread(path))


def read_image(path: str) -> np.ndarray:
    """An image file -> the array imageio.v2.imread gives: PNG decoded by
    read_png, anything else (JPG, palette or interlaced PNG) by imageio."""
    try:
        return read_png(path)
    except UnsupportedImage:
        return _imageio_imread(path)


def _jpeg_shape(path: str, data: bytes):
    """(H, W) from a JPEG's start-of-frame marker, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no length field
            pos += 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return struct.unpack(">HH", data[pos + 5:pos + 9])
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return None


def image_shape(path: str):
    """(H, W) of a PNG or JPG file from its header, without decoding the
    pixels; other files are decoded through imageio."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        w, h = _png_chunks(path, data)[0][:2]
        return h, w
    if data.startswith(b"\xff\xd8"):
        shape = _jpeg_shape(path, data)
        if shape is not None:
            return shape
    return _imageio_imread(path).shape[:2]


def save_image_grid(rows, path: str):
    """Saves a grid of [-1, 1] float images.

    Args:
      rows: list of rows; each row is a list of [H, W, 3] arrays in
        [-1, 1] concatenated horizontally. Rows are stacked vertically
        (one sample per row, panels side by side — the reference's
        nrow=1 layout).
      path: output file; parent directories are created.
    """
    grid = np.concatenate(
        [np.concatenate([np.asarray(p) for p in r], axis=1) for r in rows],
        axis=0,
    )
    grid = np.clip((grid + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, grid)
    print("Saving demo output to", path)


def normals_panel(normals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Normal map -> displayable [-1, 1] RGB panel (zeros outside mask)."""
    return np.asarray(normals) * np.asarray(mask)[..., None]


def depth_panel(depth: np.ndarray, mask: np.ndarray,
                white_background: bool) -> np.ndarray:
    """Depth map -> displayable [-1, 1] RGB panel: foreground depths are
    centered on their median and scaled by 5 m; background is white (or
    grey) (reference: eval_nusc_persp.py:566-587)."""
    depth = np.asarray(depth)
    mask = np.asarray(mask)
    fg = depth[mask >= 0.95]
    med = np.median(fg) if fg.size else 0.0
    vis = (depth - med) / 5.0
    vis = np.where(mask < 0.95, 1.0 if white_background else 0.0, vis)
    return np.clip(np.stack([vis] * 3, axis=-1), -1, 1)


def coords_panel(coords: np.ndarray, mask: np.ndarray, scene_range: float,
                 white_background: bool) -> np.ndarray:
    """Encoder NOCS coordinate map -> displayable [-1, 1] RGB panel
    (reference: run.py:2061-2069 / eval_nusc_persp.py:556-565)."""
    mask = np.asarray(mask)[..., None]
    panel = np.clip(np.asarray(coords) * mask / scene_range, -1, 1)
    if white_background:
        panel = panel + (1 - mask)
    return panel
