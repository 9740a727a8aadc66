"""Host-side image files: PNG read and write, demo composites.

The reference saves demo composites with torchvision save_image(nrow=1)
over horizontally pre-concatenated panels (reference: run.py:2144-2159,
demo_nusc.py side-by-side outputs); here a grid is assembled in numpy and
written as an 8-bit PNG by the standard library (zlib and struct), so a
machine without imageio or PIL writes it too. This package's copy of the
JAX package's utils/images.py: the same pixels as its imageio file.

The data layer reads images with `read_image`: PNG files (8- and 16-bit
gray, gray+alpha, RGB and RGBA, every row filter, no interlace) are
decoded here with zlib and numpy, and JPEG files (8-bit, Huffman coded,
baseline or progressive, gray or YCbCr with sampling factors up to 2,
restart intervals) by `read_jpeg`, the pixels imageio gives; anything
else (a palette or interlaced PNG, an arithmetic-coded, 12-bit or
lossless JPEG) goes through imageio, and raises naming the file where
imageio is missing.
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
    """A file that this module does not decode: a PNG with a palette,
    interlace or a bit depth under 8; a JPEG that is arithmetic-coded,
    12-bit, lossless or hierarchical, or has other than 1 or 3 components
    or a sampling ratio over 2; any other format."""


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


# --- JPEG -----------------------------------------------------------------
# libjpeg's defaults, which imageio (through PIL's libjpeg-turbo) decodes
# with: the integer islow IDCT (jidctint.c), "fancy" triangle chroma
# upsampling (jdsample.c) and the fixed-point YCbCr -> RGB tables
# (jdcolor.c). The entropy decoding is serial Python over per-byte 40-bit
# windows and 16-bit Huffman peek tables; the rest is numpy over all blocks.

# Zigzag index -> natural (row-major) index; 16 spare entries of 63 catch
# a corrupt run past the block's end, as libjpeg's table does.
_NATURAL = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16
_MASK = [(1 << n) - 1 for n in range(17)]
_HALF = [0] + [1 << (n - 1) for n in range(1, 17)]
_LOW = [0] + [1 - (1 << n) for n in range(1, 17)]  # HUFF_EXTEND's offset


def _huffman_lookup(counts, symbols):
    """Two 16-bit peek tables of a Huffman table. `plain`: entry (length
    << 8 | symbol) for every 16-bit window that starts with a code (0: no
    code). `fast`: where the code and its symbol's extra bits fit in the
    window, the bits they take | run << 5 | size << 9 | (extended value +
    4096) << 13 (a DC symbol's run is 0); 0 elsewhere."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    length, size, run = table >> 8, table & 15, (table >> 4) & 15
    used = length + size
    ok = (length > 0) & (used <= 16)
    extra = (np.arange(1 << 16) >> np.maximum(16 - used, 0)) & ((1 << size) - 1)
    value = np.where(extra >= np.left_shift(1, size) >> 1, extra, extra + 1 - (1 << size))
    value = np.where(size == 0, 0, value)
    fast = np.where(ok, used | run << 5 | size << 9 | (value + 4096) << 13, 0)
    return table.tolist(), fast.tolist()


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded bytes of the scan starting at `pos`, stuffing and
    fill bytes removed: (bytes, bit offset of each restart interval's
    start, position of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & (nxt != 0xFF) & ~rst]
    end = int(ends[0]) if len(ends) else len(arr)
    cuts = [-2] + [int(i) for i in ff[rst] if i < end] + [end]
    pieces, starts, n = [], [], 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg = arr[a + 2:b]
        keep = np.ones(len(seg), bool)
        is_ff = np.flatnonzero(seg[:-1] == 0xFF)
        keep[is_ff[seg[is_ff + 1] == 0] + 1] = False  # FF 00 -> FF
        keep[is_ff[seg[is_ff + 1] == 0xFF]] = False  # fill bytes
        if len(seg) and seg[-1] == 0xFF:
            keep[-1] = False
        seg = seg[keep]
        starts.append(8 * n)
        pieces.append(seg)
        n += len(seg)
    return np.concatenate(pieces + [np.zeros(8, np.uint8)]), starts, pos + end


def _windows(stream: np.ndarray) -> list:
    """win[k]: the 40 bits from byte k on, as one int."""
    b = stream.astype(np.int64)
    n = len(b) - 4
    return ((b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16)
            | (b[3:n + 3] << 8) | b[4:n + 4]).tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


def _block_order(frame, comps, ri):
    """The scan's blocks in coding order: (component slot, coefficient
    offset) lists, and the number of blocks a restart interval holds."""
    if len(comps) == 1:
        # A non-interleaved scan codes the component's own block raster.
        c = comps[0]
        rows, cols = -(-c.height // 8), -(-c.width // 8)
        by, bx = np.mgrid[:rows, :cols]
        base = ((by * c.blocks_w + bx) * 64).reshape(-1)
        slot = np.zeros_like(base)
        per_mcu = 1
    else:
        mcu_y, mcu_x = np.mgrid[:frame["mcus_y"], :frame["mcus_x"]]
        bases, slots = [], []
        for s, c in enumerate(comps):
            for v in range(c.v):
                for h in range(c.h):
                    by, bx = mcu_y * c.v + v, mcu_x * c.h + h
                    bases.append((by * c.blocks_w + bx) * 64)
                    slots.append(np.full_like(bases[-1], s))
        base = np.stack(bases, -1).reshape(-1)
        slot = np.stack(slots, -1).reshape(-1)
        per_mcu = len(bases)
    return slot.tolist(), base.tolist(), (ri * per_mcu if ri else len(base))


def _decode_sequential(win, starts, order, comps, dc_tabs, ac_tabs):
    """Baseline (and extended sequential) Huffman decoding of one scan into
    the components' coefficient lists."""
    slots, bases, per_interval = order
    outs = [c.coef for c in comps]
    dcs = [dc_tabs[c.td] for c in comps]
    acs = [ac_tabs[c.ta] for c in comps]
    pred = [0] * len(comps)
    nat, mask, half, low = _NATURAL, _MASK, _HALF, _LOW
    p = 0
    for j in range(len(bases)):
        if j % per_interval == 0:
            p = starts[j // per_interval]
            pred = [0] * len(comps)
        s_ = slots[j]
        out, base = outs[s_], bases[j]
        dc_plain, dc_fast = dcs[s_]
        ac_plain, ac_fast = acs[s_]
        peek = (win[p >> 3] >> (24 - (p & 7))) & 0xFFFF
        e = dc_fast[peek]
        if e:
            p += e & 31
            pred[s_] += (e >> 13) - 4096
        else:  # a code and extra bits longer than the window
            e = dc_plain[peek]
            if not e:
                raise ValueError("corrupt JPEG data (bad Huffman code)")
            p += e >> 8
            s = e & 15
            x = (win[p >> 3] >> (40 - (p & 7) - s)) & mask[s]
            p += s
            pred[s_] += x if x >= half[s] else x + low[s]
        out[base] = pred[s_]
        k = 1
        while k < 64:
            peek = (win[p >> 3] >> (24 - (p & 7))) & 0xFFFF
            e = ac_fast[peek]
            if e:
                p += e & 31
                if e & 0x1E00:  # size > 0: a coefficient after a run
                    k += (e >> 5) & 15
                    out[base + nat[k]] = (e >> 13) - 4096
                    k += 1
                elif e & 0x1E0 == 0x1E0:  # ZRL: 16 zeros
                    k += 16
                else:  # EOB
                    break
                continue
            e = ac_plain[peek]
            if not e:
                raise ValueError("corrupt JPEG data (bad Huffman code)")
            p += e >> 8
            s = e & 15
            k += (e >> 4) & 15
            x = (win[p >> 3] >> (40 - (p & 7) - s)) & mask[s]
            p += s
            out[base + nat[k]] = x if x >= half[s] else x + low[s]
            k += 1


def _decode_progressive(win, starts, order, comps, dc_tabs, ac_tabs, ss, se, ah, al):
    """One progressive scan: DC first or refinement (ss = 0, possibly
    interleaved), or AC first or refinement (one component, band ss..se)."""
    slots, bases, per_interval = order
    outs = [c.coef for c in comps]
    nat, mask, half, low = _NATURAL, _MASK, _HALF, _LOW
    p1, m1 = 1 << al, -1 << al
    p = 0
    if ss == 0:
        dcs = [dc_tabs[c.td][0] for c in comps] if ah == 0 else None
        pred = [0] * len(comps)
        for j in range(len(bases)):
            if j % per_interval == 0:
                p = starts[j // per_interval]
                pred = [0] * len(comps)
            s_, base = slots[j], bases[j]
            if ah:
                if (win[p >> 3] >> (39 - (p & 7))) & 1:
                    outs[s_][base] |= p1
                p += 1
                continue
            e = dcs[s_][(win[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG data (bad Huffman code)")
            p += e >> 8
            s = e & 15
            if s:
                x = (win[p >> 3] >> (40 - (p & 7) - s)) & mask[s]
                p += s
                pred[s_] += x if x >= half[s] else x + low[s]
            outs[s_][base] = pred[s_] * p1
        return
    out = outs[0]
    ac = ac_tabs[comps[0].ta][0]
    eobrun = 0
    for j in range(len(bases)):
        if j % per_interval == 0:
            p = starts[j // per_interval]
            eobrun = 0
        base = bases[j]
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = ac[(win[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data (bad Huffman code)")
                p += e >> 8
                s = e & 15
                r = (e >> 4) & 15
                if s:
                    k += r
                    x = (win[p >> 3] >> (40 - (p & 7) - s)) & mask[s]
                    p += s
                    out[base + nat[k]] = (x if x >= half[s] else x + low[s]) * p1
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (40 - (p & 7) - r)) & mask[r]
                        p += r
                    eobrun -= 1
                    break
                k += 1
            continue
        # Successive-approximation refinement of the AC band.
        k = ss
        if eobrun == 0:
            while k <= se:
                e = ac[(win[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data (bad Huffman code)")
                p += e >> 8
                s = e & 15
                r = (e >> 4) & 15
                if s:
                    s = p1 if (win[p >> 3] >> (39 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (40 - (p & 7) - r)) & mask[r]
                        p += r
                    break
                # Correction bits for the nonzero coefficients passed over,
                # up to the r-th zero one, which takes the new value.
                while k <= se:
                    i = base + nat[k]
                    c = out[i]
                    if c:
                        if (win[p >> 3] >> (39 - (p & 7))) & 1 and not c & p1:
                            out[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    out[base + nat[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                i = base + nat[k]
                c = out[i]
                if c:
                    if (win[p >> 3] >> (39 - (p & 7))) & 1 and not c & p1:
                        out[i] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


# jidctint.c's constants: FIX(x) = round(x * 2**13).
_F = {name: int(round(value * 8192)) for name, value in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _islow_pass(x: np.ndarray, shift: int) -> np.ndarray:
    """One 1-D pass of libjpeg's islow IDCT along axis 1 of int64 [N, 8, 8],
    descaled (with rounding) by `shift` bits."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, k] for k in range(8))
    z1 = (x2 + x6) * _F["0_541196100"]
    tmp2 = z1 - x6 * _F["1_847759065"]
    tmp3 = z1 + x2 * _F["0_765366865"]
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    rnd = 1 << (shift - 1)
    return np.stack((tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3), axis=1) + rnd >> shift


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients int64 [N, 8, 8] (row = vertical frequency)
    -> uint8 samples [N, 8, 8], with libjpeg's wrapping range limit."""
    ws = _islow_pass(coef, 11)  # columns: CONST_BITS - PASS1_BITS
    out = _islow_pass(ws.transpose(0, 2, 1), 18).transpose(0, 2, 1)  # rows
    out = ((out + 512) & 1023) - 512  # RANGE_MASK
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(c: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's fancy upsampling of a component's samples [h, w] by 2 in
    the factors set (h2v1, h1v2, h2v2), edges replicated; libjpeg
    replicates instead where it doubles a width of two or fewer samples."""
    if fh == 1 and fv == 1:
        return c
    c = c.astype(np.int32)
    if fh == 2 and c.shape[1] <= 2:
        return np.repeat(np.repeat(c, fv, axis=0), fh, axis=1)

    def nbr(a, axis):  # the previous and next samples along `axis`, edges kept
        first = np.take(a, [0], axis)
        last = np.take(a, [a.shape[axis] - 1], axis)
        n = a.shape[axis]
        return (np.concatenate((first, np.take(a, range(n - 1), axis)), axis),
                np.concatenate((np.take(a, range(1, n), axis), last), axis))

    def interleave(even, odd, axis):
        out = np.stack((even, odd), axis + 1)
        shape = list(even.shape)
        shape[axis] *= 2
        return out.reshape(shape)

    if fv == 2 and fh == 2:
        up, dn = nbr(c, 0)
        cols = interleave(3 * c + up, 3 * c + dn, 0)  # column sums, 4x
        left, right = nbr(cols, 1)
        return interleave((3 * cols + left + 8) >> 4, (3 * cols + right + 7) >> 4, 1)
    axis = 0 if fv == 2 else 1
    prev, nxt = nbr(c, axis)
    return interleave((3 * c + prev + 1) >> 2, (3 * c + nxt + 2) >> 2, axis)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + 32768
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack((r, g, b), -1), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file -> the array imageio.v2.imread gives: [H, W] uint8 for
    one component, [H, W, 3] RGB for three. Decodes 8-bit Huffman-coded
    baseline, extended sequential and progressive files, sampling factors
    up to 2; raises UnsupportedImage for arithmetic coding, 12-bit
    samples, lossless or hierarchical files and other component counts."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\xff\xd8"):
        raise UnsupportedImage(f"{path} is not a JPEG file")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    frame, ri, progressive = None, 0, False
    jfif = adobe = False
    adobe_transform = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[list(_NATURAL[:64])] = vals
                qts[tq] = q
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                table = _huffman_lookup(counts, list(body[i + 17:i + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = table
                i += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0-2: Huffman, sequential/progressive
            precision, h, w, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise UnsupportedImage(f"{path}: {precision}-bit JPEG samples")
            if nf not in (1, 3):
                raise UnsupportedImage(f"{path}: JPEG with {nf} components")
            if h == 0:
                raise UnsupportedImage(f"{path}: JPEG height set by a DNL marker")
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                                body[8 + 3 * k]) for k in range(nf)]
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                if (hmax % c.h or vmax % c.v or hmax // c.h > 2 or vmax // c.v > 2
                        or not 1 <= c.h <= 4 or not 1 <= c.v <= 4):
                    raise UnsupportedImage(f"{path}: JPEG sampling factors "
                                           f"{[(k.h, k.v) for k in comps]}")
                c.width, c.height = -(-w * c.h // hmax), -(-h * c.v // vmax)
                c.blocks_w, c.blocks_h = mcus_x * c.h, mcus_y * c.v
                c.coef = [0] * (c.blocks_w * c.blocks_h * 64)
                c.q = None
            frame = {"h": h, "w": w, "comps": comps, "hmax": hmax, "vmax": vmax,
                     "mcus_x": mcus_x, "mcus_y": mcus_y}
            progressive = marker == 0xC2
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = "arithmetic-coded" if marker >= 0xC9 else (
                "lossless" if marker in (0xC3, 0xC7, 0xCB, 0xCF) else "hierarchical")
            raise UnsupportedImage(f"{path}: {kind} JPEG (SOF{marker - 0xC0})")
        elif marker == 0xCC:
            raise UnsupportedImage(f"{path}: arithmetic-coded JPEG (DAC marker)")
        elif marker == 0xDD:  # DRI
            ri = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe, adobe_transform = True, body[11] if len(body) > 11 else None
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            by_id = {c.cid: c for c in frame["comps"]}
            scomps = []
            for k in range(ns):
                c = by_id[body[1 + 2 * k]]
                c.td, c.ta = body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15
                if c.q is None:  # the table is latched at the component's first scan
                    c.q = qts[c.tq]
                scomps.append(c)
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            stream, starts, pos = _scan_segments(data, pos)
            win = _windows(stream)
            order = _block_order(frame, scomps, ri)
            try:
                if progressive:
                    _decode_progressive(win, starts, order, scomps, dc_tabs, ac_tabs,
                                        ss, se, a >> 4, a & 15)
                else:
                    _decode_sequential(win, starts, order, scomps, dc_tabs, ac_tabs)
            except (IndexError, KeyError) as e:  # past the data, or a missing table
                raise ValueError(f"{path}: corrupt or truncated JPEG scan") from e
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    h, w, hmax, vmax = frame["h"], frame["w"], frame["hmax"], frame["vmax"]
    planes = []
    for c in frame["comps"]:
        coef = np.asarray(c.coef, np.int64).reshape(-1, 64)
        q = c.q if c.q is not None else np.zeros(64, np.int64)
        blocks = _idct_islow((coef * q).reshape(-1, 8, 8))
        samples = blocks.reshape(c.blocks_h, c.blocks_w, 8, 8).transpose(0, 2, 1, 3)
        samples = samples.reshape(c.blocks_h * 8, c.blocks_w * 8)[:c.height, :c.width]
        planes.append(_upsample(samples, hmax // c.h, vmax // c.v)[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    # libjpeg's default colour space of a 3-component file.
    ids = tuple(c.cid for c in frame["comps"])
    rgb = (not jfif) and ((adobe and adobe_transform == 0)
                          or (not adobe and ids == (82, 71, 66)))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*(p.astype(np.int64) for p in planes))


def _imageio_imread(path: str) -> np.ndarray:
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"{path}: this package decodes PNG (8- or 16-bit, no palette "
                          "or interlace) and 8-bit Huffman-coded JPEG; other images need "
                          "imageio, which is not installed") from e
    return np.asarray(imageio.imread(path))


def read_image(path: str) -> np.ndarray:
    """An image file -> the array imageio.v2.imread gives: PNG decoded by
    read_png, JPEG by read_jpeg, anything else (a palette or interlaced
    PNG, a JPEG that read_jpeg does not decode) by imageio."""
    with open(path, "rb") as f:
        head = f.read(2)
    try:
        return read_jpeg(path) if head == b"\xff\xd8" else read_png(path)
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
