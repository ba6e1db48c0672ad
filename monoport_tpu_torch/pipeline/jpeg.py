"""Baseline JPEG encoder in numpy: what the demo serves, with no image
library.

Baseline sequential DCT, 8-bit, three components at 4:4:4 (no chroma
subsampling), the quantization tables of ITU-T T.81 Annex K.1 scaled to a
quality the way libjpeg scales them (95, its and OpenCV's default, by
default), the typical Huffman tables of Annex K.3, JFIF YCbCr. Everything
is vectorised: the DCT is one [64, 64] matrix product over all blocks, and the
entropy coder builds every Huffman code and amplitude of the image as
arrays, sorts them into stream order and packs the bits at once.
"""

from __future__ import annotations

import struct

import numpy as np

# Annex K.1, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_Q_CHROMA = np.full(64, 99, np.int64)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 24, 25, 26, 27]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99, 47, 66, 99, 99]

# Annex K.3: (code counts by length 1..16, symbols in code order)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a838485868788"
    "898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7"
    "f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# zigzag: the natural index of each zigzag position
ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              (i % 8) if (i // 8 + i % 8) % 2 == 0
                              else (i // 8))), np.int64)


def quant_tables(quality: int = 95) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's quality scaling of the Annex K tables (natural order,
    clamped to 1..255 for baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    scaled = lambda t: np.clip((t * scale + 50) // 100, 1, 255)
    return scaled(_Q_LUMA), scaled(_Q_CHROMA)


def _huffman_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol 0..255 (length 0: no code), from the
    canonical code of the counts and symbols."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


# kind -> (codes [2, 256], lengths [2, 256]); row 0 luma, row 1 chroma
_TABLES = {kind: tuple(np.stack(t) for t in zip(*map(_huffman_codes, specs)))
           for kind, specs in (("dc", (_DC_LUMA, _DC_CHROMA)),
                               ("ac", (_AC_LUMA, _AC_CHROMA)))}
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8.0)
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
_DCT2 = np.kron(_DCT, _DCT)             # [u*8+v, x*8+y] = D[u,x] D[v,y]


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG size category; 0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The ``size`` low bits that code v (one's complement for v < 0)."""
    return np.where(v < 0, v + (1 << size) - 1, v)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8 * W/8, 64] blocks in raster order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
        -1, 64)


def quantized_blocks(rgb: np.ndarray, quality: int = 95) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [blocks, 3, 64] quantized DCT coefficients in
    zigzag order (edge-replicated to whole blocks), int64."""
    h, w, _ = rgb.shape
    img = np.pad(rgb.astype(np.float64),
                 ((0, -h % 8), (0, -w % 8), (0, 0)), mode="edge")
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b - 128.0,
           -0.168736 * r - 0.331264 * g + 0.5 * b,
           0.5 * r - 0.418688 * g - 0.081312 * b]
    blocks = np.stack([_blocks(c) for c in ycc], axis=1)      # [n, 3, 64]
    coef = blocks @ _DCT2.T             # the 2D DCT of every block at once
    q = np.stack(quant_tables(quality))[[0, 1, 1]]            # [3, 64]
    # round half away from zero, as libjpeg does
    coef = coef[..., ZIGZAG] / q[:, ZIGZAG]
    return np.trunc(coef + np.copysign(0.5, coef)).astype(np.int64)


def _scan(zz: np.ndarray) -> bytes:
    """Entropy-coded scan of [blocks, 3, 64] zigzag coefficients (the three
    components interleaved a block at a time), byte-stuffed. Every code is
    an item (stream key, code bits then amplitude bits, length); the items
    are sorted by key and their bits packed at once."""
    n = zz.shape[0]
    units = zz.reshape(n * 3, 64)                  # stream order
    table_of = np.tile([0, 1, 1], n)               # luma / chroma tables
    keys, codes, lens = [], [], []

    def add(unit, slot, kind, sym, size, amp):
        code_of, len_of = _TABLES[kind]
        t = table_of[unit]
        keys.append(unit * 128 + slot)
        codes.append((code_of[t, sym] << size) | amp)
        lens.append(len_of[t, sym] + size)

    # DC: the difference to the previous block of the same component
    diff = np.diff(units[:, 0].reshape(n, 3), axis=0, prepend=0).reshape(-1)
    size = _category(diff)
    add(np.arange(n * 3), 0, "dc", size, size, _amplitude(diff, size))
    # AC: (run, size) symbols at slot 2 pos, a ZRL (16 zeros) at slot
    # 2 pos - 1 per 16 zeros of the run before, EOB at slot 127 unless the
    # last non-zero coefficient is the 64th
    unit, pos = np.nonzero(units[:, 1:])
    pos = pos + 1
    val = units[unit, pos]
    first = np.r_[True, unit[1:] != unit[:-1]]
    run = pos - np.where(first, 0, np.r_[0, pos[:-1]]) - 1
    size = _category(val)
    add(unit, 2 * pos, "ac", (run % 16) * 16 + size, size,
        _amplitude(val, size))
    n_zrl = run // 16
    zero = np.zeros(int(n_zrl.sum()), np.int64)
    add(np.repeat(unit, n_zrl), 2 * np.repeat(pos, n_zrl) - 1, "ac",
        zero + 0xF0, zero, zero)
    last = np.zeros(n * 3, np.int64)
    np.maximum.at(last, unit, pos)
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros(len(eob), np.int64)
    add(eob, 127, "ac", zero, zero, zero)

    order = np.argsort(np.concatenate(keys), kind="stable")
    codes = np.concatenate(codes)[order]
    lens = np.concatenate(lens)[order]
    # 1-bits to a whole byte, then the bits: an item (<= 27 bits) at bit
    # offset o lies in the 5 bytes from o // 8; disjoint bits add as OR
    pad = -int(lens.sum()) % 8
    codes = np.r_[codes, (1 << pad) - 1]
    lens = np.r_[lens, pad]
    off = np.cumsum(lens) - lens
    window = codes << (40 - off % 8 - lens)
    n_bytes = int(off[-1] + lens[-1]) // 8
    data = sum(np.bincount(off // 8 + k, (window >> (32 - 8 * k)) & 0xFF,
                           minlength=n_bytes + 5) for k in range(5))
    data = data[:n_bytes].astype(np.uint8)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(cls: int, ident: int, spec) -> bytes:
    counts, symbols = spec
    return bytes([cls << 4 | ident]) + bytes(counts) + bytes(symbols)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """[H, W, 3] uint8 RGB -> a baseline JFIF JPEG (4:4:4)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want [H, W, 3] uint8, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    q_luma, q_chroma = quant_tables(quality)
    head = [b"\xff\xd8",
            _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
            _segment(0xFFDB, bytes([0]) + bytes(q_luma[ZIGZAG].tolist())
                     + bytes([1]) + bytes(q_chroma[ZIGZAG].tolist())),
            _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                     + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])),
            _segment(0xFFC4, _dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
                     + _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA)),
            _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))]
    return b"".join(head) + _scan(quantized_blocks(rgb, quality)) + b"\xff\xd9"
