"""Pure-Python FLAC encoder, RFC 9639 subset (port of
jen1_tpu/data/flac_write.py, the same code, so it writes the same bytes).

`save_audio` writes lossless FLAC through it. Every bitstream feature can be
chosen: subframe types CONSTANT / VERBATIM / FIXED(0-4) / LPC, Rice residuals
with escape partitions and multi-partition orders, stereo modes independent
/ left-side / right-side / mid-side, 8/16/24-bit depths. The header CRC-8
and frame CRC-16 are computed, so the files are valid for any decoder.

Encoding is O(T) Python: fine for generated clips (seconds to minutes of
audio), not a bulk transcoder. numpy only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _make_crc8_table():
    table = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ _CRC8_POLY) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        table.append(c)
    return table


def _make_crc16_table():
    table = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ _CRC16_POLY) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        table.append(c)
    return table


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, nbits: int) -> None:
        assert nbits >= 0
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._n += nbits
        while self._n >= 8:
            self._n -= 8
            self._bytes.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then the terminating 1

    def align(self) -> None:
        if self._n:
            self.write(0, 8 - self._n)

    def getvalue(self) -> bytes:
        assert self._n == 0, "unaligned"
        return bytes(self._bytes)


def _utf8_coded(num: int) -> bytes:
    """FLAC's extended-UTF-8 frame/sample number coding."""
    if num < 0x80:
        return bytes([num])
    out = []
    bits = num.bit_length()
    n = 2
    while bits > 6 * (n - 1) + (7 - n) and n < 7:
        n += 1
    lead = (0xFF00 >> n) & 0xFF
    shift = 6 * (n - 1)
    out.append(lead | (num >> shift))
    for i in range(n - 1):
        shift -= 6
        out.append(0x80 | ((num >> shift) & 0x3F))
    return bytes(out)


def _zigzag(v: np.ndarray) -> np.ndarray:
    return (v << 1) ^ (v >> 63)


def _write_rice_residual(
    bw: BitWriter,
    res: np.ndarray,
    blocksize: int,
    order: int,
    partition_order: int = 0,
    rice_param: Optional[int] = None,
    escape_bits: Optional[int] = None,
) -> None:
    """method=0 (4-bit Rice). escape_bits forces every partition to the
    escape (raw) encoding with that bit width."""
    bw.write(0, 2)
    bw.write(partition_order, 4)
    partitions = 1 << partition_order
    assert blocksize % partitions == 0
    psize = blocksize >> partition_order
    res = np.asarray(res, np.int64)
    idx = 0
    for p in range(partitions):
        count = psize - (order if p == 0 else 0)
        chunk = res[idx : idx + count]
        idx += count
        if escape_bits is not None:
            bw.write(0xF, 4)
            bw.write(escape_bits, 5)
            for v in chunk:
                bw.write_signed(int(v), escape_bits)
            continue
        if rice_param is None:
            mean = float(np.mean(np.abs(chunk))) if len(chunk) else 0.0
            k = max(0, int(np.ceil(np.log2(mean + 1))) if mean > 0 else 0)
            k = min(k, 14)
        else:
            k = rice_param
        bw.write(k, 4)
        for u in _zigzag(chunk):
            bw.write_unary(int(u) >> k)
            if k:
                bw.write(int(u) & ((1 << k) - 1), k)


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _write_subframe(
    bw: BitWriter,
    x: np.ndarray,
    bps: int,
    kind: str,
    order: int = 2,
    wasted: int = 0,
    partition_order: int = 0,
    rice_param: Optional[int] = None,
    escape_bits: Optional[int] = None,
    lpc_coefs: Optional[list] = None,
    lpc_shift: int = 1,
) -> None:
    x = np.asarray(x, np.int64)
    if wasted:
        assert (x & ((1 << wasted) - 1) == 0).all(), "wasted bits must be zero"
        x = x >> wasted
        bps_eff = bps - wasted
    else:
        bps_eff = bps
    blocksize = len(x)

    bw.write(0, 1)  # padding
    if kind == "constant":
        assert (x == x[0]).all()
        bw.write(0b000000, 6)
        _write_wasted(bw, wasted)
        bw.write_signed(int(x[0]), bps_eff)
    elif kind == "verbatim":
        bw.write(0b000001, 6)
        _write_wasted(bw, wasted)
        for v in x:
            bw.write_signed(int(v), bps_eff)
    elif kind == "fixed":
        assert 0 <= order <= 4
        bw.write(0b001000 | order, 6)
        _write_wasted(bw, wasted)
        for v in x[:order]:
            bw.write_signed(int(v), bps_eff)
        coefs = _FIXED_COEFS[order]
        res = x[order:].copy()
        for j, c in enumerate(coefs):
            res -= c * x[order - 1 - j : blocksize - 1 - j]
        _write_rice_residual(bw, res, blocksize, order, partition_order,
                             rice_param, escape_bits)
    elif kind == "lpc":
        coefs = lpc_coefs if lpc_coefs is not None else [3, -1]
        order = len(coefs)
        assert 1 <= order <= 32
        bw.write(0b100000 | (order - 1), 6)
        _write_wasted(bw, wasted)
        for v in x[:order]:
            bw.write_signed(int(v), bps_eff)
        prec = max(int(np.max(np.abs(coefs))).bit_length() + 1, 2)
        bw.write(prec - 1, 4)
        bw.write_signed(lpc_shift, 5)
        for c in coefs:
            bw.write_signed(int(c), prec)
        pred = np.zeros(blocksize - order, np.int64)
        for j, c in enumerate(coefs):
            pred += int(c) * x[order - 1 - j : blocksize - 1 - j]
        res = x[order:] - (pred >> lpc_shift)
        _write_rice_residual(bw, res, blocksize, order, partition_order,
                             rice_param, escape_bits)
    else:
        raise ValueError(f"unknown subframe kind: {kind}")


def _write_wasted(bw: BitWriter, wasted: int) -> None:
    if wasted == 0:
        bw.write(0, 1)
    else:
        bw.write(1, 1)
        bw.write_unary(wasted - 1)


_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_STEREO_ASSIGN = {"left_side": 8, "right_side": 9, "mid_side": 10}


def write_flac(
    path: str,
    samples: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    block_size: int = 4096,
    subframe: str = "fixed",
    stereo: str = "independent",
    order: int = 2,
    partition_order: int = 0,
    rice_param: Optional[int] = None,
    escape_bits: Optional[int] = None,
    wasted: int = 0,
    lpc_coefs: Optional[list] = None,
    lpc_shift: int = 1,
) -> None:
    """samples: (T, C) integers at full `bits` scale (e.g. int16 range for
    bits=16), or float32 in [-1, 1] (quantized here)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.dtype.kind == "f":
        samples = np.clip(samples, -1.0, 1.0 - 2.0 ** -(bits - 1))
        samples = np.round(samples * (1 << (bits - 1))).astype(np.int64)
    else:
        samples = samples.astype(np.int64)
    total, channels = samples.shape
    if stereo != "independent":
        assert channels == 2, "stereo decorrelation needs 2 channels"

    si = BitWriter()
    si.write(block_size, 16)  # min blocksize
    si.write(block_size, 16)  # max blocksize
    si.write(0, 24)  # min framesize (unknown)
    si.write(0, 24)  # max framesize (unknown)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(total & ((1 << 36) - 1), 36)
    for _ in range(16):
        si.write(0, 8)  # md5 unset
    streaminfo = si.getvalue()

    out = bytearray(b"fLaC")
    out.append(0x80)  # last-metadata-block, type 0 (STREAMINFO)
    out += len(streaminfo).to_bytes(3, "big")
    out += streaminfo

    frame_no = 0
    for start in range(0, total, block_size):
        block = samples[start : start + block_size]
        bs = len(block)
        hdr = BitWriter()
        hdr.write(0b11111111111110, 14)
        hdr.write(0, 1)  # reserved
        hdr.write(0, 1)  # fixed blocksize stream
        hdr.write(7, 4)  # blocksize: 16-bit value-1 follows
        hdr.write(0, 4)  # sample rate: from STREAMINFO
        assign = 0
        if stereo == "independent":
            assign = channels - 1
        else:
            assign = _STEREO_ASSIGN[stereo]
        hdr.write(assign, 4)
        hdr.write(_BPS_CODE[bits], 3)
        hdr.write(0, 1)  # reserved
        for b in _utf8_coded(frame_no):
            hdr.write(b, 8)
        hdr.write(bs - 1, 16)
        hdr_bytes = hdr.getvalue()

        body = BitWriter()
        if stereo == "independent":
            subs = [(block[:, c], bits) for c in range(channels)]
        else:
            left = block[:, 0]
            right = block[:, 1]
            side = left - right
            if stereo == "left_side":
                subs = [(left, bits), (side, bits + 1)]
            elif stereo == "right_side":
                subs = [(side, bits + 1), (right, bits)]
            else:  # mid_side
                mid = (left + right) >> 1
                subs = [(mid, bits), (side, bits + 1)]
        for x, bps in subs:
            kind = subframe
            if kind == "constant" and not (x == x[0]).all():
                kind = "verbatim"
            _write_subframe(
                body, x, bps, kind, order=order, wasted=wasted,
                partition_order=partition_order if bs % (1 << partition_order) == 0 else 0,
                rice_param=rice_param, escape_bits=escape_bits,
                lpc_coefs=lpc_coefs, lpc_shift=lpc_shift,
            )
        body.align()
        frame = hdr_bytes + bytes([crc8(hdr_bytes)]) + body.getvalue()
        frame += crc16(frame).to_bytes(2, "big")
        out += frame
        frame_no += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
