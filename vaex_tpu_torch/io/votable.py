"""VOTable TABLEDATA in the standard library's XML (vaex_tpu/io/votable.py;
no astropy): ``parse_votable`` reads a table into numpy arrays (an empty
cell or the declared null value masked), ``export_votable`` writes one a
chunk of rows at a time.  The reference's TAP client needs a network and is
not ported."""

from __future__ import annotations

import numpy as np

from . import export_rows, replacing

# VOTable datatype -> numpy (VOTable 1.4, table 6)
_VOT_TO_NP = {
    "boolean": np.dtype("bool"), "unsignedByte": np.dtype("u1"), "short": np.dtype("i2"),
    "int": np.dtype("i4"), "long": np.dtype("i8"), "float": np.dtype("f4"),
    "double": np.dtype("f8"), "char": np.dtype(object), "unicodeChar": np.dtype(object),
}
_NP_TO_VOT = {"b1": "boolean", "u1": "unsignedByte", "i2": "short", "i4": "int",
              "i8": "long", "f4": "float", "f8": "double"}


def _local(tag):
    return tag.rsplit("}", 1)[-1]


def _iter_local(el, name):
    for child in el.iter():
        if _local(child.tag) == name:
            yield child


def parse_votable(source):
    """A VOTable (a path, a file or bytes) as {name: numpy array}, masked
    where a cell is empty or holds the field's null value."""
    import io
    import xml.etree.ElementTree as ET
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    root = ET.parse(source).getroot()
    table = next(_iter_local(root, "TABLE"), None)
    if table is None:
        raise ValueError("no TABLE element in the VOTable")
    fields = []
    for f in _iter_local(table, "FIELD"):
        values = next(_iter_local(f, "VALUES"), None)
        fields.append((f.get("name") or f.get("ID"), _VOT_TO_NP.get(f.get("datatype"),
                                                                   np.dtype("f8")),
                       None if values is None else values.get("null")))
    data = next(_iter_local(table, "TABLEDATA"), None)
    if data is None:
        raise ValueError("only the TABLEDATA serialization is read (convert a BINARY or "
                         "FITS VOTable first)")
    rows = [[c.text for c in _iter_local(tr, "TD")] for tr in _iter_local(data, "TR")]
    columns = {}
    for j, (name, dt, null) in enumerate(fields):
        raw = [row[j] if j < len(row) else None for row in rows]
        if dt == object:
            values = np.asarray(["" if v is None else v for v in raw], dtype=object)
            mask = np.asarray([v is None for v in raw], dtype=bool)
        else:
            mask = np.asarray([v is None or v == "" or (null is not None and v == null)
                               for v in raw], dtype=bool)
            fill = "false" if dt.kind == "b" else "0"
            cells = [fill if m else v for v, m in zip(raw, mask)]
            if dt.kind == "b":
                values = np.asarray([v.strip().lower() in ("true", "t", "1") for v in cells],
                                    dtype=bool)
            elif dt.kind in "iu":
                values = np.asarray([int(v) for v in cells], dtype=dt)
            else:
                values = np.asarray(cells, dtype=dt)
        columns[name] = np.ma.MaskedArray(values, mask) if mask.any() else values
    return columns


def open_votable(path):
    from .. import from_arrays
    return from_arrays(**parse_votable(path))


def export_votable(df, path, progress=None, chunk_size=None):
    """A TABLEDATA VOTable of the frame's columns, a chunk of rows at a
    time; a missing value an empty cell, a datetime or timedelta its int64
    count as a ``long`` (the reference writes it as a ``double`` its own
    reader cannot parse)."""
    import xml.sax.saxutils as sx
    from .. import array_types
    names = df.get_column_names()
    with replacing(path) as tmp, open(tmp, "w") as f:
        f.write('<?xml version="1.0" encoding="utf-8"?>\n'
                '<VOTABLE version="1.4" xmlns="http://www.ivoa.net/xml/VOTable/v1.3">\n'
                "<RESOURCE><TABLE>\n")
        for name in names:
            dt = df.data_type(name)
            kind = "char" if dt.is_text else "long" if dt.is_temporal else _NP_TO_VOT.get(
                dt.numpy.str.lstrip("<>=|"), "double")
            size = ' arraysize="*"' if dt.is_text else ""
            f.write(f'<FIELD name={sx.quoteattr(name)} datatype="{kind}"{size}/>\n')
        f.write("<DATA><TABLEDATA>\n")
        for i1, i2, part in export_rows(df, chunk_size or 65536):
            cells = []
            for name in names:
                values = part.evaluate(name)
                if array_types.is_arrow(values):
                    values = array_types.string_arrow(values).to_pylist()
                    cells.append(["<TD/>" if v is None else f"<TD>{sx.escape(v)}</TD>"
                                  for v in values])
                    continue
                data, mask = array_types.data_and_mask(values)
                if data.dtype.kind in "Mm":  # the int64 count (NaT its minimum)
                    data = data.view(np.int64)
                cells.append(["<TD/>" if mask is not None and mask[i] else
                              f"<TD>{sx.escape(str(v))}</TD>" for i, v in enumerate(data.tolist())])
            for row in zip(*cells):
                f.write("<TR>" + "".join(row) + "</TR>\n")
        f.write("</TABLEDATA></DATA>\n</TABLE></RESOURCE>\n</VOTABLE>\n")
    return path
