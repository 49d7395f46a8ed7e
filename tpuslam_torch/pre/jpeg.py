"""The plain JPEG decoder: the native loader's JPEG path in Python and numpy.

``decode_jpeg_gray8(path)`` gives the bytes libjpeg gives for gray output
(``out_color_space = JCS_GRAYSCALE``, its default islow IDCT), which are the
bytes of the reference's loader and of ``native/frameloader.cpp``.  It is
written from the format (ITU T.81: markers, Huffman codes of Annex C,
the decoding procedures of Annex F and G) and from libjpeg's documented
arithmetic (``jidctint.c``'s islow IDCT, ``jdmaster.c``'s range-limit
table), not from the C++, so that a slip in one shows against the other.

It reads what the loader reads — baseline, extended sequential and
progressive Huffman files of 8-bit samples, one component or three
(YCbCr), interleaved scans or not, restart intervals — and refuses what it
refuses, raising ``FrameDecodeError`` with the same words
(``native_loader.JPEG_REFUSED``).  libjpeg's handling of a corrupt stream
is kept where it sets the pixels: past the end of a segment's data the
bits read as zeros, and from the MCU that read past it to the next good
restart marker the blocks are left as they are; a code that matches no
symbol spends 17 bits and decodes as 0; the standard tables of Annex K
fill table slots 0 and 1 left empty at the first scan.  The entropy decoder
is a Python loop (about a second a 1392x512 frame); the IDCT runs on all
blocks at once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tpuslam_torch.pre.native_loader import JPEG_REFUSED, FrameDecodeError


class JpegError(ValueError):
    """A JPEG file the decoders cannot read: not a JPEG, or corrupt."""


def _zigzag() -> list[int]:
    """Natural (row-major) index of each zigzag position, walking the anti-diagonals (T.81 Figure A.6)."""
    order = []
    for s in range(15):
        diag = [(r, s - r) for r in range(8) if 0 <= s - r < 8]
        order += [8 * r + c for r, c in (diag if s % 2 else diag[::-1])]
    return order


ZIGZAG = _zigzag()
# A run past the block's end in a corrupt stream lands on the last coefficient, as in libjpeg.
_NATURAL = ZIGZAG + [63] * 16


def _annex_k(counts: str, symbols: str) -> tuple[list[int], bytes]:
    return [int(c, 16) for c in counts.split()], bytes.fromhex(symbols)


_STD_DC_LUMA = _annex_k("0 1 5 1 1 1 1 1 1 0 0 0 0 0 0 0", "000102030405060708090a0b")
_STD_DC_CHROMA = _annex_k("0 3 1 1 1 1 1 1 1 1 1 0 0 0 0 0", "000102030405060708090a0b")
_STD_AC_LUMA = _annex_k(
    "0 2 1 3 3 2 4 3 5 5 4 4 0 0 1 7d",
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
    "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
    "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6"
    "f7f8f9fa")
_STD_AC_CHROMA = _annex_k(
    "0 2 1 2 4 4 3 4 7 5 4 4 0 1 2 77",
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a"
    "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a929394959697"
    "98999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6"
    "f7f8f9fa")


def _refuse(path, status: int):
    raise FrameDecodeError(f"{path}: {JPEG_REFUSED[status]}")


def _code_table(counts: list[int], symbols: bytes, dc: bool, path) -> list[int]:
    """Annex C's canonical codes as a 16-bit lookahead: entry = (code length << 8) | symbol.

    An entry no code matches costs 17 bits and decodes as 0.
    """
    table = np.full(1 << 16, 17 << 8, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            if code >= (1 << length):  # an all-ones code, or more codes than fit
                raise JpegError(f"{path}: bad Huffman table")
            if dc and symbols[k] > 15:
                raise JpegError(f"{path}: DC category {symbols[k]} in a DC table")
            lo = code << (16 - length)
            table[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        if n and code >= (1 << length):
            raise JpegError(f"{path}: bad Huffman table")
        code <<= 1
    return table.tolist()


class _Segments:
    """The file as libjpeg's stdio source reads it, and its entropy-coded data cut at markers."""

    def __init__(self, data: bytes, start: int):
        self.data, self.pos = data, start

    def byte(self, i: int) -> int:
        """Byte i; past the end, the EOI markers libjpeg's file source inserts."""
        if i < len(self.data):
            return self.data[i]
        return 0xD9 if (i - len(self.data)) % 2 else 0xFF

    def segment(self) -> tuple[bytes, int]:
        """The data bytes from pos up to the next marker (stuffing removed) and that marker; pos after it."""
        out = bytearray()
        i = self.pos
        while True:
            c = self.byte(i)
            i += 1
            if c != 0xFF:
                out.append(c)
                continue
            while self.byte(i) == 0xFF:
                i += 1
            m = self.byte(i)
            i += 1
            if m == 0:
                out.append(0xFF)
                continue
            self.pos = i
            return bytes(out), m

    def next_marker(self) -> int:
        """The next marker after pos (data bytes and stuffed zeros skipped); pos after it."""
        return self.segment()[1]


class _Bits:
    """MSB-first bits of one segment; zeros past its end, remembering that a bit past it was read."""

    def __init__(self, data: bytes = b""):  # empty: a restart that left a marker in the way
        padded = np.frombuffer(data + bytes(8), np.uint8).astype(np.int64)
        self.words = ((padded[:-3] << 24) | (padded[1:-2] << 16) | (padded[2:-1] << 8) | padded[3:]).tolist()
        self.size = 8 * len(data)
        self.pos = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        if p >= self.size:
            return 0
        return (self.words[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def symbol(self, table: list[int]) -> int:
        p = self.pos
        e = table[(self.words[p >> 3] >> (16 - (p & 7))) & 0xFFFF] if p < self.size else table[0]
        self.pos = p + (e >> 8)
        return e & 0xFF

    @property
    def past_end(self) -> bool:
        return self.pos > self.size


def _extend(v: int, t: int) -> int:
    """F.2.2.1's EXTEND: the t-bit magnitude category value v → its signed value."""
    return v - (1 << t) + 1 if v < (1 << (t - 1)) else v


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _int16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Frame:
    def __init__(self, path):
        self.path = path
        self.q: dict[int, list[int]] = {}
        self.dc: dict[int, tuple] = {}
        self.ac: dict[int, tuple] = {}
        self.restart = 0
        self.jfif = False
        self.adobe: int | None = None
        self.sof: int | None = None
        self.scans = 0

    # -- markers ---------------------------------------------------------------------

    def markers(self, seg: _Segments, first_marker: int | None = None):
        """Marker segments up to the next SOS (→ its body and the offset after it) or EOI (→ None)."""
        m = first_marker
        while True:
            if m is None:
                m = seg.next_marker()
            if m == 0xD9:
                return None
            if m == 0x01 or 0xD0 <= m <= 0xD7:
                m = None
                continue
            if m == 0xD8:
                raise JpegError(f"{self.path}: a second SOI")
            length = (seg.byte(seg.pos) << 8) | seg.byte(seg.pos + 1)
            if length < 2:
                raise JpegError(f"{self.path}: marker {m:#x} of length {length}")
            body = bytes(seg.byte(i) for i in range(seg.pos + 2, seg.pos + length))
            if m == 0xDA:
                return body, seg.pos + length
            self.segment(m, body)
            seg.pos += length
            m = None

    def segment(self, m: int, body: bytes) -> None:
        if m in (0xC0, 0xC1, 0xC2):
            self.frame_header(m, body)
        elif m in (0xC9, 0xCA, 0xCB):
            _refuse(self.path, 6)
        elif m == 0xC3:
            _refuse(self.path, 7)
        elif m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF, 0xDE, 0xDF):
            _refuse(self.path, 9)
        elif m == 0xC4:
            i = 0
            while i + 17 <= len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1 : i + 17])
                n = sum(counts)
                if tc > 1 or th > 3 or i + 17 + n > len(body):
                    raise JpegError(f"{self.path}: bad DHT")
                (self.ac if tc else self.dc)[th] = (counts, body[i + 17 : i + 17 + n])
                i += 17 + n
            if i != len(body):
                raise JpegError(f"{self.path}: bad DHT length")
        elif m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                if tq > 3 or i + 1 + 64 * width > len(body):
                    raise JpegError(f"{self.path}: bad DQT")
                vals = body[i + 1 : i + 1 + 64 * width]
                zz = [int.from_bytes(vals[k * width : (k + 1) * width], "big") for k in range(64)]
                q = [0] * 64
                for k, v in enumerate(zz):
                    q[ZIGZAG[k]] = v
                self.q[tq] = q
                i += 1 + 64 * width
        elif m == 0xDD:
            if len(body) != 2:
                raise JpegError(f"{self.path}: bad DRI")
            self.restart = int.from_bytes(body, "big")
        elif m == 0xE0:
            self.jfif = self.jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif m == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                self.adobe = body[11]
        elif not (0xE0 <= m <= 0xEF or m in (0xCC, 0xDC, 0xFE)):
            raise JpegError(f"{self.path}: unknown marker {m:#x}")

    def frame_header(self, m: int, body: bytes) -> None:
        if self.sof is not None:
            raise JpegError(f"{self.path}: a second SOF")
        self.sof = m
        if len(body) < 6:
            raise JpegError(f"{self.path}: short SOF")
        precision, self.height, self.width, nc = body[0], int.from_bytes(body[1:3], "big"), \
            int.from_bytes(body[3:5], "big"), body[5]
        if len(body) != 6 + 3 * nc or nc == 0 or self.width == 0:
            raise JpegError(f"{self.path}: bad SOF")
        if precision != 8:
            _refuse(self.path, 8)
        if self.height == 0:
            _refuse(self.path, 13)
        if nc not in (1, 3):
            _refuse(self.path, 10)
        self.comps = []
        for k in range(nc):
            cid, hv, tq = body[6 + 3 * k : 9 + 3 * k]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise JpegError(f"{self.path}: sampling factors {h}x{v}")
            self.comps.append({"id": cid, "h": h, "v": v, "tq": tq, "q": None, "bits": [-1] * 64})
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        self.mcus = (_ceil(self.width, 8 * self.hmax), _ceil(self.height, 8 * self.vmax))
        for c in self.comps:  # A.1.1: the component's samples, then the blocks that cover them
            c["blocks"] = (_ceil(_ceil(self.width * c["h"], self.hmax), 8),
                           _ceil(_ceil(self.height * c["v"], self.vmax), 8))
            c["grid"] = (self.mcus[0] * c["h"], self.mcus[1] * c["v"])
            c["coef"] = None

    def check_colour(self) -> None:
        if len(self.comps) == 3 and not self.jfif:
            ids = [c["id"] for c in self.comps]
            if (self.adobe == 0) or (self.adobe is None and ids == [ord("R"), ord("G"), ord("B")]):
                _refuse(self.path, 11)
        luma = self.comps[0]
        if luma["h"] < self.hmax or luma["v"] < self.vmax:
            _refuse(self.path, 12)

    # -- scans -------------------------------------------------------------------------

    def scan(self, body: bytes, seg: _Segments) -> int:
        """One scan (its SOS body) → the marker that ended it."""
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            raise JpegError(f"{self.path}: bad SOS")
        members = []
        for k in range(ns):
            cid, tables = body[1 + 2 * k], body[2 + 2 * k]
            found = [c for c in self.comps if c["id"] == cid]
            if not found or any(found[0] is c for c, _, _ in members):
                raise JpegError(f"{self.path}: scan component {cid}")
            members.append((found[0], tables >> 4, tables & 15))
        ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
        if self.scans == 0:  # libjpeg gives empty slots 0 and 1 the standard tables before its first scan
            self.dc.setdefault(0, _STD_DC_LUMA)
            self.dc.setdefault(1, _STD_DC_CHROMA)
            self.ac.setdefault(0, _STD_AC_LUMA)
            self.ac.setdefault(1, _STD_AC_CHROMA)
        self.scans += 1
        progressive = self.sof == 0xC2
        if progressive and ((ss == 0 and se != 0) or (ss > 0 and (ss > se or se > 63 or ns != 1))
                            or (ah and al != ah - 1) or al > 13):
            raise JpegError(f"{self.path}: bad progression Ss={ss} Se={se} Ah={ah} Al={al}")
        kind = "seq" if not progressive else ("dc" if ss == 0 else "ac") + ("_refine" if ah else "_first")
        work = []
        for c, td, ta in members:
            if c["q"] is None:
                if c["tq"] not in self.q:
                    raise JpegError(f"{self.path}: no quantisation table {c['tq']}")
                c["q"] = list(self.q[c["tq"]])
                c["coef"] = [0] * (c["grid"][0] * c["grid"][1] * 64)
            dct = act = None
            if kind in ("seq", "dc_first"):
                if td not in self.dc:
                    raise JpegError(f"{self.path}: no DC table {td}")
                dct = _code_table(*self.dc[td], True, self.path)
            if kind in ("seq", "ac_first", "ac_refine"):
                if ta not in self.ac:
                    raise JpegError(f"{self.path}: no AC table {ta}")
                act = _code_table(*self.ac[ta], False, self.path)
            if progressive:
                for k in range(ss, se + 1):
                    c["bits"][k] = al
            work.append((c, dct, act))
        if ns == 1:
            c = members[0][0]
            cols, rows = c["blocks"]
            units = [[(0, (r * c["grid"][0] + x) * 64)] for r in range(rows) for x in range(cols)]
        else:
            if sum(c["h"] * c["v"] for c, _, _ in members) > 10:
                raise JpegError(f"{self.path}: more than 10 blocks an MCU")
            cols, rows = self.mcus
            units = []
            for my in range(rows):
                for mx in range(cols):
                    unit = []
                    for k, (c, _, _) in enumerate(members):
                        for by in range(c["v"]):
                            for bx in range(c["h"]):
                                unit.append((k, ((my * c["v"] + by) * c["grid"][0] + mx * c["h"] + bx) * 64))
                    units.append(unit)
        return self.decode_units(units, work, kind, ss, se, al, seg)

    def decode_units(self, units, work, kind, ss, se, al, seg: _Segments) -> int:
        """Decode the scan's MCUs (``units``: each a list of (member, coefficient offset)) → the marker
        that ended the scan, left for the marker reader."""
        data, pending = seg.segment()
        bits = _Bits(data)
        expected, left, short = 0, self.restart, False
        preds, eob = [0] * len(work), [0]
        for unit in units:
            if self.restart:
                if left == 0:  # F.2.2.5: the predictions and the EOB run start again after RSTn
                    left_marker = self.resync(pending, expected, seg)
                    expected = (expected + 1) % 8
                    if left_marker is None:
                        data, pending = seg.segment()
                        bits, short = _Bits(data), False
                    else:
                        pending, bits = left_marker, _Bits()
                    preds, eob = [0] * len(work), [0]
                    left = self.restart
                left -= 1
            if short and kind != "dc_refine":
                continue  # libjpeg leaves the rest of the interval as it is
            for k, off in unit:
                c, dct, act = work[k]
                coef = c["coef"]
                if kind == "seq":
                    t = bits.symbol(dct)
                    preds[k] += _extend(bits.get(t), t) if t else 0
                    coef[off] = _int16(preds[k])
                    i = 1
                    while i < 64:
                        rs = bits.symbol(act)
                        r, t = rs >> 4, rs & 15
                        if t:
                            i += r
                            coef[off + _NATURAL[i]] = _extend(bits.get(t), t)
                        elif r != 15:
                            break
                        else:
                            i += 15
                        i += 1
                elif kind == "dc_first":
                    t = bits.symbol(dct)
                    preds[k] += _extend(bits.get(t), t) if t else 0
                    coef[off] = _int16(preds[k] << al)
                elif kind == "dc_refine":
                    if bits.get(1):
                        coef[off] |= 1 << al
                elif kind == "ac_first":
                    self.ac_first(bits, act, coef, off, ss, se, al, eob)
                else:
                    self.ac_refine(bits, act, coef, off, ss, se, al, eob)
            short = short or bits.past_end
        return pending

    @staticmethod
    def resync(marker: int, expected: int, seg: _Segments) -> int | None:
        """libjpeg's restart: None when RST``expected`` (or one too far from it to tell) is taken, else the
        marker left for later; markers of earlier restarts and stray ones are skipped past."""
        while True:
            if 0xC0 <= marker and not 0xD0 <= marker <= 0xD7:
                return marker
            if 0xD0 <= marker <= 0xD7:
                n = marker - 0xD0
                if n in ((expected + 1) % 8, (expected + 2) % 8):
                    return marker
                if n not in ((expected - 1) % 8, (expected - 2) % 8):
                    return None
            marker = seg.next_marker()

    @staticmethod
    def ac_first(bits, act, coef, off, ss, se, al, eob) -> None:
        if eob[0]:
            eob[0] -= 1
            return
        i = ss
        while i <= se:
            rs = bits.symbol(act)
            r, t = rs >> 4, rs & 15
            if t:
                i += r
                coef[off + _NATURAL[i]] = _int16(_extend(bits.get(t), t) << al)
            elif r == 15:
                i += 15
            else:
                eob[0] = (1 << r) + bits.get(r) - 1
                return
            i += 1

    @staticmethod
    def ac_refine(bits, act, coef, off, ss, se, al, eob) -> None:
        """G.1.2.3: correction bits for the nonzero coefficients passed over, in band order."""
        p1 = 1 << al

        def correct(pos: int) -> None:
            if bits.get(1) and not coef[pos] & p1:
                coef[pos] += p1 if coef[pos] >= 0 else -p1

        i = ss
        if eob[0] == 0:
            while i <= se:
                rs = bits.symbol(act)
                r, t = rs >> 4, rs & 15
                new = 0
                if t:
                    new = p1 if bits.get(1) else -p1  # a new coefficient is one bit, whatever its size says
                elif r != 15:
                    eob[0] = (1 << r) + bits.get(r)
                    break
                while i <= se:  # pass r zero coefficients, correcting the nonzero ones on the way
                    pos = off + _NATURAL[i]
                    if coef[pos]:
                        correct(pos)
                    elif r == 0:
                        break
                    else:
                        r -= 1
                    i += 1
                if new:
                    coef[off + _NATURAL[i]] = new
                i += 1
        if eob[0]:
            while i <= se:
                pos = off + _NATURAL[i]
                if coef[pos]:
                    correct(pos)
                i += 1
            eob[0] -= 1

    def smoothed(self) -> bool:
        """Whether libjpeg would smooth luma's blocks (a progressive image with AC 1..9 of luma unrefined)."""
        if self.sof != 0xC2:
            return False
        low = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
        if any(c["q"] is None or c["bits"][0] < 0 or any(c["q"][k] == 0 for k in low) for c in self.comps):
            return False
        return any(b != 0 for b in self.comps[0]["bits"][1:10])


def _idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's islow IDCT on (N, 8, 8) coefficient blocks (rows v, columns u) → (N, 8, 8) uint8.

    Integer arithmetic with 13 fractional bits in the constants and 2 kept
    after the column pass (CONST_BITS, PASS1_BITS), 64-bit sums (JLONG),
    the column pass's results cut to 32 bits (the int workspace), and the
    output through jdmaster.c's range-limit table at ``& 1023``.
    """
    const = {"0.298631336": 2446, "0.390180644": 3196, "0.541196100": 4433, "0.765366865": 6270,
             "0.899976223": 7373, "1.175875602": 9633, "1.501321110": 12299, "1.847759065": 15137,
             "1.961570560": 16069, "2.053119869": 16819, "2.562915447": 20995, "3.072711026": 25172}
    c = {k: np.int64(v) for k, v in const.items()}

    def butterfly(x0, x1, x2, x3, x4, x5, x6, x7):
        """One 1-D pass on the eight inputs (each an array) → eight unscaled outputs."""
        z1 = (x2 + x6) * c["0.541196100"]
        e2 = z1 - x6 * c["1.847759065"]
        e3 = z1 + x2 * c["0.765366865"]
        e0 = (x0 + x4) * 8192
        e1 = (x0 - x4) * 8192
        t10, t13, t11, t12 = e0 + e3, e0 - e3, e1 + e2, e1 - e2
        o0, o1, o2, o3 = x7, x5, x3, x1
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * c["1.175875602"]
        o0 = o0 * c["0.298631336"]
        o1 = o1 * c["2.053119869"]
        o2 = o2 * c["3.072711026"]
        o3 = o3 * c["1.501321110"]
        z1 = z1 * -c["0.899976223"]
        z2 = z2 * -c["2.562915447"]
        z3 = z3 * -c["1.961570560"] + z5
        z4 = z4 * -c["0.390180644"] + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        return (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    x = coef.astype(np.int64) * quant.astype(np.int16).astype(np.int64)[None]
    cols = butterfly(*(x[:, r, :] for r in range(8)))  # down each column
    ws = np.stack([descale(v, 13 - 2) for v in cols], axis=1).astype(np.int32).astype(np.int64)
    rows = butterfly(*(ws[:, :, k] for k in range(8)))  # along each row
    out = np.stack([descale(v, 13 + 2 + 3) for v in rows], axis=2)
    limit = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(128)]).astype(np.uint8)
    return limit[out & 1023]


def decode_jpeg_gray8(path: str | Path) -> np.ndarray:
    """Decode a JPEG → (H, W) uint8 gray, the bytes libjpeg's gray output gives: the loader's plain version.

    Raises ``JpegError`` (a ``ValueError``) for a file that is not a JPEG
    or is corrupt beyond what libjpeg reads through, and ``FrameDecodeError``
    naming the variant for one the decoders refuse.
    """
    return decode_jpeg_gray8_bytes(Path(path).read_bytes(), path)


def jpeg_size(data: bytes, name) -> tuple[int, int]:
    """(height, width) from the frame header of the JPEG ``data`` (``name`` in errors), refusals raised."""
    if data[:2] != b"\xff\xd8":
        raise JpegError(f"{name}: not a JPEG file")
    frame = _Frame(name)
    if frame.markers(_Segments(data, 2)) is None or frame.sof is None:
        raise JpegError(f"{name}: no frame or no scan")
    frame.check_colour()
    return frame.height, frame.width


def decode_jpeg_gray8_bytes(data: bytes, name) -> np.ndarray:
    """``decode_jpeg_gray8`` of the JPEG in ``data`` (a file's bytes, or a video frame's payload, read as
    libjpeg reads a file); ``name`` names it in errors."""
    path = name
    if data[:2] != b"\xff\xd8":
        raise JpegError(f"{path}: not a JPEG file")
    frame = _Frame(path)
    seg = _Segments(data, 2)
    sos = frame.markers(seg)
    if sos is None or frame.sof is None:
        raise JpegError(f"{path}: no frame or no scan")
    frame.check_colour()
    single = frame.sof != 0xC2 and sos[0][0] == len(frame.comps)  # one scan holds the whole image
    while sos is not None:
        body, seg.pos = sos
        end = frame.scan(body, seg)
        if single:
            break
        sos = frame.markers(seg, end)
    if frame.smoothed():
        _refuse(path, 14)
    luma = frame.comps[0]
    if luma["coef"] is None:
        return np.full((frame.height, frame.width), 128, np.uint8)
    gw, gh = luma["grid"]
    bw, bh = luma["blocks"]
    blocks = np.asarray(luma["coef"], np.int64).astype(np.int16).reshape(gh, gw, 8, 8)[:bh, :bw]
    pixels = _idct_islow(blocks.reshape(-1, 8, 8), np.asarray(luma["q"]).reshape(8, 8))
    image = pixels.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(8 * bh, 8 * bw)
    return np.ascontiguousarray(image[: frame.height, : frame.width])
