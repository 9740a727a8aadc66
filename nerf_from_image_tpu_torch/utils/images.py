"""Host-side image export helpers (demo composites).

The reference saves demo composites with torchvision save_image(nrow=1)
over horizontally pre-concatenated panels (reference: run.py:2144-2159,
demo_nusc.py side-by-side outputs); here a grid is assembled in numpy and
written as an 8-bit RGB PNG by the standard library (zlib and struct), so
a machine without imageio or PIL writes it too. This package's copy of
the JAX package's utils/images.py: the same pixels as its imageio file.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Writes a [H, W, 3] uint8 array as an 8-bit RGB PNG (no interlace,
    filter 0 on every row)."""
    h, w, c = rgb.shape
    if rgb.dtype != np.uint8 or c != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")
    rows = np.concatenate((np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)), axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Reads back what write_png writes: an 8-bit RGB PNG whose rows all
    use filter 0 -> [H, W, 3] uint8. Raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + 3 * w):
        raise ValueError(f"{path}: {rows.size} bytes of pixels for {h}x{w}")
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


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
