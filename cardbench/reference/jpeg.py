"""The benchmark's plain baseline JPEG decoder (ITU-T T.81), in numpy:
what a browser does with a part of the served MJPEG stream.

Markers (SOI, APPn and COM skipped, DQT of 8- or 16-bit tables, SOF0 /
SOF1, DHT, DRI, SOS with its restart intervals, EOI), Huffman decoding of
the interleaved scan, dequantisation, the 8x8 inverse DCT and JFIF's
YCbCr to RGB, for three components sampled 1x1 (4:4:4) or one grey
component. Anything else, and a stream that ends before its EOI or in the
middle of its scan, raises ``ValueError``. Imports nothing of the system
under test.
"""

from __future__ import annotations

import struct

import numpy as np

# the natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the 1D DCT-II basis: C[u, x] = c(u) / 2 cos((2x + 1) u pi / 16)
_C = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2.0
                * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])


class _Huffman:
    """A table as a 16-bit lookup: the next 16 bits of the stream -> (the
    symbol, the code's length); length 0 where no code starts so."""

    def __init__(self, counts, symbols):
        sym = np.zeros(1 << 16, np.int64)
        length = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for n_bits, n in enumerate(counts, start=1):
            for _ in range(n):
                lo = code << (16 - n_bits)
                hi = (code + 1) << (16 - n_bits)
                if hi > 1 << 16:
                    raise ValueError("an over-full Huffman table")
                sym[lo:hi] = symbols[k]
                length[lo:hi] = n_bits
                code, k = code + 1, k + 1
            code <<= 1
        self.sym, self.length = sym.tolist(), length.tolist()


class _Bits:
    """An MSB-first reader over an interval's entropy-coded bytes (byte
    stuffing already removed)."""

    def __init__(self, data: bytes):
        self.n_bits = 8 * len(data)
        self.data = data + b"\x00\x00\x00\x00"
        self.pos = 0

    def _window(self) -> int:
        p = self.pos >> 3
        return int.from_bytes(self.data[p:p + 3], "big") << (self.pos & 7)

    def symbol(self, table: _Huffman) -> int:
        peek = (self._window() >> 8) & 0xFFFF
        n = table.length[peek]
        if n == 0 or self.pos + n > self.n_bits:
            raise ValueError("a corrupt or truncated scan")
        self.pos += n
        return table.sym[peek]

    def value(self, size: int) -> int:
        """``size`` bits as a signed amplitude (T.81 F.2.2.1's EXTEND)."""
        if size == 0:
            return 0
        if self.pos + size > self.n_bits:
            raise ValueError("a truncated scan")
        v = ((self._window() & 0xFFFFFF) >> (24 - size)) & ((1 << size) - 1)
        self.pos += size
        return v if v >= 1 << (size - 1) else v - (1 << size) + 1


def _entropy_intervals(data: bytes, at: int):
    """(the restart intervals' unstuffed bytes, the offset of the marker
    that ends the scan)."""
    out, cur, i, n = [], bytearray(), at, len(data)
    while i < n:
        b = data[i]
        if b != 0xFF:
            cur.append(b)
            i += 1
            continue
        if i + 1 >= n:
            break
        nxt = data[i + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i += 2
        elif 0xD0 <= nxt <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            i += 2
        elif nxt == 0xFF:
            i += 1                                   # fill byte
        else:
            out.append(bytes(cur))
            return out, i
    raise ValueError("the stream ends inside its scan")


def _segments(data: bytes):
    """(marker, payload, offset after it) of each marker segment up to the
    first SOS (whose offset is where its entropy-coded data starts)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI marker")
    i = 2
    while True:
        if i + 4 > len(data) or data[i] != 0xFF:
            raise ValueError(f"no marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:
            i += 1
            continue
        (length,) = struct.unpack(">H", data[i + 2:i + 4])
        end = i + 2 + length
        if end > len(data):
            raise ValueError("a truncated marker segment")
        yield marker, data[i + 4:end], end
        if marker == 0xDA:
            return
        i = end


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG -> [H, W, 3] uint8 RGB ([H, W, 1] for grey)."""
    data = bytes(data)
    qt: dict = {}
    tables: dict = {}
    frame = None
    restart = 0
    for marker, p, end in _segments(data):
        if marker == 0xDB:                                       # DQT
            j = 0
            while j < len(p):
                prec, ident = p[j] >> 4, p[j] & 15
                n = 128 if prec else 64
                q = np.frombuffer(p[j + 1:j + 1 + n],
                                  ">u2" if prec else "u1").astype(np.int64)
                if len(q) != 64:
                    raise ValueError("a truncated quantisation table")
                qt[ident] = q                                    # zigzag
                j += 1 + n
        elif marker in (0xC0, 0xC1):                             # SOF0/1
            if p[0] != 8:
                raise ValueError(f"{p[0]}-bit samples")
            h, w, nc = struct.unpack(">HHB", p[1:6])
            comps = [(p[6 + 3 * k], p[7 + 3 * k], p[8 + 3 * k])
                     for k in range(nc)]
            if nc not in (1, 3) or any(c[1] != 0x11 for c in comps):
                raise ValueError("only 1x1-sampled grey or 4:4:4 colour")
            frame = (h, w, comps)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"SOF marker 0x{marker:02x} is not baseline")
        elif marker == 0xC4:                                     # DHT
            j = 0
            while j < len(p):
                cls, ident = p[j] >> 4, p[j] & 15
                counts = list(p[j + 1:j + 17])
                n = sum(counts)
                tables[cls, ident] = _Huffman(counts, p[j + 17:j + 17 + n])
                j += 17 + n
        elif marker == 0xDD:                                     # DRI
            (restart,) = struct.unpack(">H", p[:2])
        elif marker == 0xDA:                                     # SOS
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = p[0]
            scan = [(p[1 + 2 * k], p[2 + 2 * k] >> 4, p[2 + 2 * k] & 15)
                    for k in range(ns)]
            start = end
    h, w, comps = frame
    if [c[0] for c in scan] != [c[0] for c in comps]:
        raise ValueError("a scan that is not the frame's one interleaved scan")
    intervals, at = _entropy_intervals(data, start)
    if data[at:at + 2] != b"\xff\xd9":
        raise ValueError("no EOI after the scan")
    bh, bw = -(-h // 8), -(-w // 8)
    n_mcu = bh * bw
    per = restart or n_mcu
    if len(intervals) != -(-n_mcu // per):
        raise ValueError("restart intervals do not cover the frame")
    nc = len(comps)
    coef = np.zeros((n_mcu, nc, 64), np.int64)
    dc_t = [tables[0, s[1]] for s in scan]
    ac_t = [tables[1, s[2]] for s in scan]
    for k, chunk in enumerate(intervals):
        bits = _Bits(chunk)
        pred = [0] * nc
        for m in range(k * per, min((k + 1) * per, n_mcu)):
            for c in range(nc):
                zz = [0] * 64
                pred[c] += bits.value(bits.symbol(dc_t[c]))
                zz[0] = pred[c]
                i = 1
                while i < 64:
                    rs = bits.symbol(ac_t[c])
                    run, size = rs >> 4, rs & 15
                    if size == 0:
                        if run != 15:
                            break                                 # EOB
                        i += 16
                        continue
                    i += run
                    if i > 63:
                        raise ValueError("a coefficient past the block")
                    zz[i] = bits.value(size)
                    i += 1
                coef[m, c] = zz
    q = np.stack([qt[cp[2]] for cp in comps])                    # zigzag
    blocks = np.zeros((n_mcu, nc, 64))
    blocks[..., ZIGZAG] = coef * q
    blocks = blocks.reshape(n_mcu, nc, 8, 8)
    pix = np.einsum("ux,...uv,vy->...xy", _C, blocks, _C) + 128.0
    planes = pix.reshape(bh, bw, nc, 8, 8).transpose(2, 0, 3, 1, 4).reshape(
        nc, bh * 8, bw * 8)[:, :h, :w]
    if nc == 1:
        rgb = planes[0][..., None]
    else:
        y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
        rgb = np.stack([y + 1.402 * cr,
                        y - 0.344136 * cb - 0.714136 * cr,
                        y + 1.772 * cb], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
