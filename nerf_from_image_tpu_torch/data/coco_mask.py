"""COCO run-length-encoded mask decode/encode.

Drop-in replacement for the pycocotools.mask functions the reference data
layer depends on (reference: data/datasets.py:327 decode,
data/datasets.py:77 encode). This package's copy of the JAX package's
codec, pure numpy: that package's optional native accelerator
(data/_native/rle.c) is not carried over, so the encoded bytes and the
decoded masks are those of its numpy path. Malformed input (a truncated
counts string, negative runs, runs that do not cover the mask) raises
ValueError.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _decode_counts(s: bytes) -> List[int]:
    """Decodes pycocotools' compressed LEB128-style counts string."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            if i >= n:
                raise ValueError("malformed RLE counts string: truncated run")
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> bytes:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode(rle: Dict) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': bytes|list} -> [h, w] uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    if isinstance(counts, bytes):
        counts = _decode_counts(counts)
    counts = np.asarray(counts, np.int64)
    if (counts < 0).any() or int(counts.sum()) != h * w:
        raise ValueError(f"RLE runs do not cover a {h}x{w} mask")
    # Runs alternate background/foreground, column-major.
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((w, h)).T.copy()


def encode(mask: np.ndarray) -> Dict:
    """[h, w] {0,1} mask -> compressed RLE dict (column-major runs)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # Run lengths with a leading zero-run if the mask starts with 1.
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate(([0], change, [flat.size]))
    runs = np.diff(boundaries).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": _encode_counts(runs)}
