"""Writes the JPEG fixtures of this folder and the pixels imageio gives
for them: `python -m nerf_from_image_tpu_torch.data.jpeg.make_fixtures`.

Needs PIL and imageio (the files are committed; tests and chip_smoke.py
only read them). Each small fixture <name>.jpg gets <name>.npy, the
array imageio.v2.imread returns. The 1600x900 nuScenes-like CAM_FRONT
frame (the first frame of data/driving_fixtures.build_nusc_tree at the
camera's size) gets CAM_FRONT_FRAME.json with the SHA-256 of imageio's
pixels, their shape and per-channel sums, instead of 4.3 MB of pixels.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, shape, PIL save options): subsampling 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0.
SMALL = (
    ("baseline_420", (45, 61, 3), {"quality": 85, "subsampling": 2}),
    ("baseline_422", (45, 61, 3), {"quality": 85, "subsampling": 1}),
    ("baseline_444", (45, 61, 3), {"quality": 85, "subsampling": 0}),
    ("grey", (45, 61), {"quality": 85}),
    ("restart_420", (45, 61, 3), {"quality": 85, "subsampling": 2,
                                  "restart_marker_blocks": 3}),
    ("progressive_420", (45, 61, 3), {"quality": 85, "subsampling": 2,
                                      "progressive": True}),
)
CAM_FRONT_FRAME = "n008-fixture__CAM_FRONT__0000.jpg"


def pattern_image(shape, seed: int) -> np.ndarray:
    """Ramps, a checker and noise: every frequency band gets coefficients."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[:h, :w]
    img = np.stack((xx * 255.0 / w, yy * 255.0 / h, ((xx // 4 + yy // 4) % 2) * 200.0), -1)
    img = img + rng.normal(0.0, 18.0, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else img


def pixel_digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape),
            "channel_sums": [int(s) for s in img.reshape(-1, img.shape[-1]).sum(0)]}


def main() -> None:
    import imageio.v2 as imageio
    from PIL import Image

    from nerf_from_image_tpu_torch.data import driving_fixtures
    from nerf_from_image_tpu_torch.utils.images import read_png

    for k, (name, shape, options) in enumerate(SMALL):
        path = os.path.join(HERE, name + ".jpg")
        Image.fromarray(pattern_image(shape, k)).save(path, "JPEG", **options)
        np.save(os.path.join(HERE, name + ".npy"), np.asarray(imageio.imread(path)))
    with tempfile.TemporaryDirectory() as tmp:
        tree = driving_fixtures.build_nusc_tree(tmp)
        frame = read_png(os.path.join(tmp, "samples/CAM_FRONT", tree["frames"][0]))
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=75, subsampling=2)
    path = os.path.join(HERE, CAM_FRONT_FRAME)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    with open(os.path.join(HERE, "CAM_FRONT_FRAME.json"), "w") as f:
        json.dump(pixel_digest(np.asarray(imageio.imread(path))), f, indent=1)


if __name__ == "__main__":
    main()
