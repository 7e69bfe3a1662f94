"""Image IO: minimal dependency-free PNG write/read + tonemap.

Replaces the swapchain/window output of the reference (main.cpp:92) with
offline image files, and stb_image (C6 in SURVEY.md §2) for the debug path.

A copy of vct_tpu/utils/image.py (numpy, struct and zlib): the port keeps
its own host modules and imports nothing of the JAX package;
tests/test_torch_image.py pins its bytes and decodes equal.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, gamma: float = 2.2, exposure: float = 1.0) -> np.ndarray:
    """Linear HDR -> display: exposure, clamp, gamma. Returns uint8.

    The reference renders to an 8-bit default framebuffer with no tonemap —
    i.e. linear values clamp to [0,1] (gamma=1.0 reproduces that exactly).
    """
    x = np.clip(np.asarray(img, np.float32) * exposure, 0.0, 1.0)
    if gamma != 1.0:
        x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8/float image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = tonemap(img, gamma=1.0)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))
    out = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, non-interlaced, filters 0-4)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            assert bitdepth == 8 and interlace == 0, "unsupported PNG"
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                             np.uint8).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:
            cur = line.copy()
            for i in range(channels, stride):
                cur[i] = (cur[i] + cur[i - channels]) & 0xFF
        elif filt == 2:
            cur = (line + prev) & 0xFF
        elif filt == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - channels] if i >= channels else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif filt == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, channels)


# ---------------------------------------------------------------------------
# Baseline JPEG decode (SURVEY.md C6: stb_image decodes PNG/JPG/TGA for the
# material textures, Model.h:141-186).  Sequential baseline DCT (SOF0/SOF1),
# canonical Huffman, YCbCr with 4:4:4 / 4:2:2 / 4:2:0 subsampling, restart
# markers.  Pure numpy + a Python bit loop — asset-load-time only.
# ---------------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

_IDCT8 = None


def _idct_matrix() -> np.ndarray:
    global _IDCT8
    if _IDCT8 is None:
        k = np.arange(8)
        c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
        _IDCT8 = 0.5 * c[None, :] * np.cos(
            (2 * k[:, None] + 1) * k[None, :] * np.pi / 16.0)
    return _IDCT8


class _Huff:
    """Canonical MSB-first Huffman: per-length (min_code, first_index)."""

    def __init__(self, counts, symbols):
        self.symbols = symbols
        self.min_code = np.zeros(17, np.int64)
        self.max_code = np.full(17, -1, np.int64)
        self.first = np.zeros(17, np.int64)
        code = 0
        idx = 0
        for ln in range(1, 17):
            n = counts[ln - 1]
            if n:
                self.min_code[ln] = code
                self.max_code[ln] = code + n - 1
                self.first[ln] = idx
                idx += n
                code += n
            code <<= 1


class _Bits:
    """Entropy-coded segment reader: 0xFF00 de-stuffing, stops at markers."""

    def __init__(self, data, pos):
        self.d = data.tolist()      # python ints: uint8 arithmetic traps
        self.p = pos
        self.acc = 0
        self.n = 0
        self.marker = None

    def _fill(self):
        while self.n <= 24:
            if self.marker is not None:
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.n += 8
                continue
            b = self.d[self.p]
            if b == 0xFF:
                nxt = self.d[self.p + 1]
                if nxt == 0x00:
                    self.p += 2
                elif 0xD0 <= nxt <= 0xD7:
                    self.marker = nxt        # restart: handled by caller
                    continue
                else:
                    self.marker = nxt
                    continue
            else:
                self.p += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.n += 8

    def restart(self):
        """Consume an RSTn marker and realign to a byte boundary."""
        self.acc = 0
        self.n = 0
        assert self.marker is not None and 0xD0 <= self.marker <= 0xD7
        self.p += 2
        self.marker = None

    def bits(self, k):
        if k == 0:
            return 0
        if self.n < k:
            self._fill()
        v = (self.acc >> (self.n - k)) & ((1 << k) - 1)
        self.n -= k
        return v

    def huff(self, tbl):
        if self.n < 16:
            self._fill()
        code = 0
        avail = self.acc & ((1 << self.n) - 1)
        for ln in range(1, 17):
            code = (code << 1) | ((avail >> (self.n - ln)) & 1)
            if tbl.max_code[ln] >= 0 and code <= tbl.max_code[ln]:
                self.n -= ln
                return int(
                    tbl.symbols[tbl.first[ln] + code - tbl.min_code[ln]])
        raise ValueError("bad JPEG huffman code")


def _extend(v, t):
    return v - ((1 << t) - 1) if t and v < (1 << (t - 1)) else v


def read_jpg(path: str) -> np.ndarray:
    """Decode a baseline JPEG -> float32 (H, W, 3) RGB in [0, 1]."""
    d = np.fromfile(path, np.uint8)
    assert d[0] == 0xFF and d[1] == 0xD8, "not a JPEG"
    p = 2
    qt = {}
    hufftabs = {}
    comps = None
    h = w = 0
    interval = 0
    while True:
        assert d[p] == 0xFF, "bad marker"
        m = d[p + 1]
        p += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        ln = (int(d[p]) << 8) | int(d[p + 1])
        seg = d[p + 2:p + ln]
        if m == 0xDB:                                  # DQT
            q = 0
            while q < len(seg):
                prec, tid = seg[q] >> 4, seg[q] & 15
                if prec:
                    tbl = (seg[q + 1:q + 129:2].astype(np.int32) << 8) \
                        | seg[q + 2:q + 129:2]
                    q += 129
                else:
                    tbl = seg[q + 1:q + 65].astype(np.int32)
                    q += 65
                qt[tid] = tbl
        elif m in (0xC0, 0xC1):                        # SOF0/1 baseline
            h = (int(seg[1]) << 8) | int(seg[2])
            w = (int(seg[3]) << 8) | int(seg[4])
            nc = int(seg[5])
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]
                comps.append(dict(id=int(cid), hs=int(hv) >> 4,
                                  vs=int(hv) & 15, tq=int(tq)))
        elif m in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                   0xCD, 0xCE, 0xCF):
            raise NotImplementedError(
                f"only baseline JPEG is supported (SOF marker {m:#x})")
        elif m == 0xC4:                                # DHT
            q = 0
            while q < len(seg):
                cls, tid = seg[q] >> 4, seg[q] & 15
                counts = seg[q + 1:q + 17].astype(np.int32)
                total = int(counts.sum())
                syms = seg[q + 17:q + 17 + total].astype(np.int32)
                hufftabs[(int(cls), int(tid))] = _Huff(counts, syms)
                q += 17 + total
        elif m == 0xDD:                                # DRI
            interval = (int(seg[0]) << 8) | int(seg[1])
        elif m == 0xDA:                                # SOS
            ns = int(seg[0])
            scan = []
            for c in range(ns):
                cs, tt = int(seg[1 + 2 * c]), int(seg[2 + 2 * c])
                comp = next(cc for cc in comps if cc["id"] == cs)
                scan.append((comp, tt >> 4, tt & 15))
            p += ln
            break
        p += ln

    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    planes = []
    for c in comps:
        cw = -(-w * c["hs"] // hmax)
        ch = -(-h * c["vs"] // vmax)
        planes.append(np.zeros((mcuy * c["vs"] * 8, mcux * c["hs"] * 8),
                               np.float32))
        c["w"], c["h"] = cw, ch

    br = _Bits(d, p)
    idct = _idct_matrix()
    pred = [0] * len(scan)
    mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if interval and mcu and mcu % interval == 0:
                br._fill()
                if br.marker is not None and 0xD0 <= br.marker <= 0xD7:
                    br.restart()
                pred = [0] * len(scan)
            for ci, (c, td, ta) in enumerate(scan):
                dct = hufftabs[(0, td)]
                act = hufftabs[(1, ta)]
                q = qt[c["tq"]]
                for by in range(c["vs"]):
                    for bx in range(c["hs"]):
                        zz = np.zeros(64, np.int32)
                        t = br.huff(dct)
                        diff = _extend(br.bits(t), t)
                        pred[ci] += diff
                        zz[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = br.huff(act)
                            r, sz = rs >> 4, rs & 15
                            if sz == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break                  # EOB
                            k += r
                            zz[k] = _extend(br.bits(sz), sz)
                            k += 1
                        blk = np.zeros(64, np.float32)
                        blk[_ZIGZAG] = zz * q
                        px = (idct @ blk.reshape(8, 8) @ idct.T) + 128.0
                        y0 = (my * c["vs"] + by) * 8
                        x0 = (mx * c["hs"] + bx) * 8
                        planes[comps.index(c)][y0:y0 + 8, x0:x0 + 8] = px
            mcu += 1

    # upsample chroma to full res, crop, YCbCr -> RGB
    full = []
    for c, pl in zip(comps, planes):
        ry, rx = vmax // c["vs"], hmax // c["hs"]
        if ry > 1 or rx > 1:
            pl = np.repeat(np.repeat(pl, ry, axis=0), rx, axis=1)
        full.append(pl[:h, :w])
    if len(full) == 1:
        y = np.clip(full[0], 0, 255)
        return np.repeat((y / 255.0).astype(np.float32)[..., None], 3, -1)
    y, cb, cr = full[0], full[1] - 128.0, full[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0, 255) / 255.0).astype(np.float32)
