"""FITS binary tables in numpy (vaex_tpu/io/fits.py; no astropy): 2880-byte
blocks of 80-character header cards, then big-endian rows.  A column is a
strided view of the memory-mapped rows, byte-swapped a slice at a time
(:class:`ColumnFits`): opening reads no row.  Fixed-width ASCII strings are
read at open."""

from __future__ import annotations

import numpy as np

from ..column import ColumnHost, file_identity
from ..dataset import DatasetFile
from . import export_rows, replacing

BLOCK = 2880
CARD = 80

_TFORM_TO_DTYPE = {
    "L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}
_DTYPE_TO_TFORM = {v: k for k, v in _TFORM_TO_DTYPE.items()}


def _read_header(f):
    """(the cards of one header unit, its bytes)."""
    cards, nbytes = {}, 0
    while True:
        block = f.read(BLOCK)
        if len(block) != BLOCK:
            raise EOFError("truncated FITS header")
        nbytes += BLOCK
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                return cards, nbytes
            if "=" in card[8:10]:
                value = card[10:].split("/")[0].strip()
                if value.startswith("'"):
                    value = value.strip()[1:-1].strip()
                cards[key] = value


def _pad(n):
    return -(-n // BLOCK) * BLOCK


def _data_size(cards):
    naxis = int(cards.get("NAXIS", 0))
    if naxis == 0:
        return 0
    size = abs(int(cards.get("BITPIX", 8))) // 8
    for i in range(1, naxis + 1):
        size *= int(cards.get(f"NAXIS{i}", 0))
    return size * int(cards.get("GCOUNT", 1)) + int(cards.get("PCOUNT", 0))


class ColumnFits(ColumnHost):
    """One big-endian field of the memory-mapped rows: a slice is copied and
    byte-swapped to the native order."""

    def __init__(self, rows, offset, dtype_be):
        self.rows, self.offset, self.dtype_be = rows, offset, dtype_be
        self.dtype = dtype_be.newbyteorder("=")

    def __len__(self):
        return self.rows.shape[0]

    def _read(self, i1, i2):
        raw = self.rows[i1:i2, self.offset:self.offset + self.dtype_be.itemsize]
        return np.ascontiguousarray(raw).view(self.dtype_be).reshape(-1).astype(self.dtype)


class FitsDataset(DatasetFile):
    """The first BINTABLE extension of a FITS file."""

    def __init__(self, path):
        with open(path, "rb") as fh:
            super().__init__(path, file_identity(path, fh.fileno()))
            cards, hbytes = _read_header(fh)
            offset = hbytes + _pad(_data_size(cards))
            while True:
                fh.seek(offset)
                try:
                    cards, hbytes = _read_header(fh)
                except EOFError:
                    raise IOError(f"{path}: no BINTABLE extension found") from None
                data_offset = offset + hbytes
                if cards.get("XTENSION", "").startswith("BINTABLE"):
                    break
                offset = data_offset + _pad(_data_size(cards))
            nrows, rowbytes = int(cards["NAXIS2"]), int(cards["NAXIS1"])
            rows = np.memmap(fh, dtype=np.uint8, mode="r", offset=data_offset,
                             shape=(nrows, rowbytes)) if nrows else np.zeros((0, rowbytes),
                                                                             np.uint8)
        at = 0
        for i in range(1, int(cards["TFIELDS"]) + 1):
            name = cards.get(f"TTYPE{i}", f"col{i}").strip()
            tform = cards.get(f"TFORM{i}", "").strip()
            repeat = int("".join(c for c in tform if c.isdigit()) or 1)
            code = tform[-1] if tform and tform[-1].isalpha() else tform
            if code == "A":  # fixed-width ASCII
                raw = rows[:, at:at + repeat]
                self.add_column(name, np.asarray(
                    [bytes(r).decode("ascii", "replace").rstrip() for r in raw], dtype=object))
                at += repeat
                continue
            dtype = _TFORM_TO_DTYPE.get(code)
            if dtype is None:
                at += repeat
                continue
            if repeat == 1:
                self.add_column(name, ColumnFits(rows, at, np.dtype(dtype)))
            at += repeat * np.dtype(dtype).itemsize
        self._row_count = nrows


def open_fits(path):
    from .. import from_dataset
    return from_dataset(FitsDataset(path))


def _card(key, value):
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, str):
        v = f"'{value:<8}'"
    else:
        v = str(value)
    return f"{key:<8}= {v:>20}"[:80].ljust(80)


def _block(cards):
    text = "".join(cards) + "END".ljust(80)
    return text.ljust(_pad(len(text))).encode("ascii")


def export_fits(df, path, progress=None, chunk_size=None):
    """A primary HDU and one BINTABLE, its rows written a chunk at a time
    (vaex_tpu/io/fits.py:162-219): numbers in the nearest FITS type (float64
    for any other; a datetime or timedelta as its int64 count, which the
    reference cannot write), a missing float as NaN, strings as fixed-width ASCII as
    wide as the longest (one pass over the strings first), a null string
    empty."""
    from .. import array_types
    names = df.get_column_names()
    fields = []  # (name, TFORM, big-endian dtype or None, width in bytes)
    for name in names:
        dt = df.data_type(name)
        if dt.is_text:
            width = 1
            for _, _, part in export_rows(df, chunk_size):
                values = array_types.string_arrow(part.evaluate(name)).to_pylist()
                width = max([width] + [len(v.encode("ascii", "replace")) for v in values if v])
            fields.append((name, f"{width}A", None, width))
        else:
            npdt = np.dtype(np.int64) if dt.is_temporal else np.dtype(dt.numpy)
            be = npdt.newbyteorder(">")
            code = _DTYPE_TO_TFORM.get(be.str)
            if code is None:
                be, code = np.dtype(">f8"), "D"
            fields.append((name, f"1{code}", be, be.itemsize))
    n, rowbytes = len(df), sum(f[3] for f in fields)
    header = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8), _card("NAXIS", 2),
              _card("NAXIS1", rowbytes), _card("NAXIS2", n), _card("PCOUNT", 0),
              _card("GCOUNT", 1), _card("TFIELDS", len(fields))]
    for i, (name, tform, _, _) in enumerate(fields, 1):
        header += [_card(f"TTYPE{i}", name), _card(f"TFORM{i}", tform)]
    with replacing(path) as tmp, open(tmp, "wb") as f:
        f.write(_block([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
                        _card("EXTEND", True)]))
        f.write(_block(header))
        for i1, i2, part in export_rows(df, chunk_size):
            table = np.zeros((i2 - i1, rowbytes), np.uint8)
            at = 0
            for name, _, be, width in fields:
                values = part.evaluate(name)
                if be is None:
                    raw = np.full((i2 - i1, width), 0x20, np.uint8)
                    for r, s in enumerate(array_types.string_arrow(values).to_pylist()):
                        b = (s or "").encode("ascii", "replace")[:width]
                        raw[r, :len(b)] = np.frombuffer(b, np.uint8)
                else:
                    data, mask = array_types.data_and_mask(values)
                    data = (data.view(np.int64) if data.dtype.kind in "Mm" else data).astype(be)
                    if mask is not None and be.kind == "f":
                        data[mask] = np.nan
                    raw = data.reshape(-1, 1).view(np.uint8)
                table[:, at:at + width] = raw
                at += width
            f.write(table.tobytes())
        payload = n * rowbytes
        f.write(b"\0" * (_pad(payload) - payload))
    return path
