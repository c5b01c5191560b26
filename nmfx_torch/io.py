"""GCT / RES expression-matrix I/O (copy of the dense half of
``nmfx/io.py``).

Covers the reference's R readers/writer ``read.dataset``/``read.gct``/
``read.res``/``write.gct`` (``nmf.r:261-408``). A GCT file's numeric
block is parsed and formatted by the port's C++ host library
(``nmfx_torch/native``: ``std::from_chars`` / ``std::to_chars``); values
are written exactly as the reference package writes them (shortest
round-trip digits, ``std::to_chars`` notation), so either package reads
the other's files to the bit. ``gct_body_text`` is the Python formatter
the native one is held to. The sparse formats (``.mtx``, ``.csr.npz``)
are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import numpy as np

from nmfx_torch import native
from nmfx_torch.config import ROADMAP_SCALE


class Dataset(NamedTuple):
    """An expression matrix with row/column labels."""

    values: np.ndarray  # (n_rows, n_cols) float64
    row_names: list[str]
    col_names: list[str]

    @property
    def shape(self):
        return self.values.shape


def read_dataset(path: str) -> Dataset:
    """Dispatch on file extension (reference ``read.dataset``,
    nmf.r:261-269)."""
    lower = path.lower()
    if lower.endswith(".gct"):
        return read_gct(path)
    if lower.endswith(".res"):
        return read_res(path)
    if lower.endswith((".mtx", ".csr.npz")):
        raise NotImplementedError(
            f"{path}: sparse inputs are not ported yet ({ROADMAP_SCALE})")
    raise ValueError(f"Input is not a res/gct file: {path}")


#: rows per streamed parse batch (read_gct)
_GCT_CHUNK_ROWS = 2048


def read_gct(path: str, chunk_rows: int = _GCT_CHUNK_ROWS) -> Dataset:
    """Read a GCT v1.2 file (reference ``read.gct``, nmf.r:371-377).

    Layout: line 1 version tag ``#1.2``; line 2 ``<rows>TAB<cols>``; line 3
    header ``Name TAB Description TAB <sample names...>``; then one row per
    gene: name, description, values. The Description column is dropped, as
    the reference does. The header fixes the output shape, so the values
    array is allocated once and rows are parsed in ``chunk_rows`` batches
    straight into it.
    """
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    with open(path, "rb") as f:
        version = f.readline().decode().strip()
        if not version.startswith("#"):
            raise ValueError(
                f"{path}: missing GCT version line, got {version!r}")
        dims = f.readline().decode().split()
        if len(dims) < 2:
            raise ValueError(f"{path}: malformed GCT dimension line")
        n_rows, n_cols = int(dims[0]), int(dims[1])
        header = f.readline().decode().rstrip("\r\n").split("\t")
        col_names = [c for c in header[2:] if c != ""]
        values = np.empty((n_rows, n_cols), np.float64)
        row_names: list[str] = []
        chunk: list[bytes] = []
        seen = 0  # data rows encountered (counted past n_rows for the error)

        def _flush() -> None:
            r0 = seen - len(chunk)
            try:
                block, _ = native.parse_gct_rows(
                    b"\n".join(chunk) + b"\n", len(chunk), n_cols)
            except ValueError as e:
                raise ValueError(
                    f"{path}: {e}; expected name<TAB>description<TAB>"
                    f"{n_cols} numeric values per row") from e
            values[r0:seen] = block
            chunk.clear()

        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line:  # skip blank lines
                continue
            seen += 1
            if seen > n_rows:
                continue  # keep counting for the row-count error below
            tab = line.find(b"\t")
            row_names.append(
                line[:tab if tab != -1 else len(line)].decode())
            chunk.append(line)
            if len(chunk) >= chunk_rows:
                _flush()
        if seen == n_rows and chunk:
            _flush()
        if seen != n_rows:
            raise ValueError(
                f"{path}: found {seen} data rows, header said {n_rows}")
    if len(col_names) != n_cols:
        # tolerate headers with trailing junk; fall back to numbered columns
        col_names = (col_names + [str(i + 1) for i in range(n_cols)])[:n_cols]
    return Dataset(values, row_names, col_names)


def read_res(path: str) -> Dataset:
    """Read a RES file (reference ``read.res``, nmf.r:351-369).

    RES interleaves a value column and a call column per sample; sample
    names sit at every 2nd header field starting at the 3rd. Row names come
    from the Accession (2nd) column; line 3 holds the row count.
    """
    with open(path, "rt") as f:
        header = f.readline().rstrip("\n").split("\t")
        col_names = [c for c in header[2::2] if c != ""]
        f.readline()  # per-sample description line, unused
        n_rows = int(f.readline().split()[0])
        row_names: list[str] = []
        numeric: list[str] = []
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            row_names.append(fields[1])
            numeric.append("\t".join(fields[2::2]))
    values = (np.loadtxt(numeric, delimiter="\t", dtype=np.float64,
                         comments=None, ndmin=2)
              if numeric else np.empty((0, len(col_names))))
    if values.shape[0] != n_rows:
        raise ValueError(
            f"{path}: found {values.shape[0]} data rows, header said {n_rows}")
    if values.shape[1] != len(col_names):
        raise ValueError(
            f"{path}: {values.shape[1]} value columns vs {len(col_names)} "
            "names")
    return Dataset(values, row_names, col_names)


def _to_chars_double(v: float) -> str:
    """Python equivalent of ``std::to_chars(double)``: shortest round-trip
    digits in fixed or scientific notation, whichever is SHORTER (fixed
    on ties), as C++17 [charconv.to.chars] specifies."""
    if v != v:
        return "-nan" if math.copysign(1.0, v) < 0 else "nan"
    if v in (float("inf"), float("-inf")):
        return "-inf" if v < 0 else "inf"
    if v == 0.0:
        return "-0" if str(v)[0] == "-" else "0"
    from decimal import Decimal

    sign, digits, exp = Decimal(repr(float(v))).as_tuple()
    ds = "".join(map(str, digits)).rstrip("0") or "0"
    exp += len(digits) - len(ds)  # fold stripped trailing zeros into exp
    # value = ds × 10^exp; scientific exponent E places the point after ds[0]
    e = exp + len(ds) - 1
    sci = (ds[0] + ("." + ds[1:] if len(ds) > 1 else "")
           + f"e{'+' if e >= 0 else '-'}{abs(e):02d}")
    if exp >= 0:
        # integral value: in fixed notation the exact integer wins
        fixed = str(abs(int(v)))
    elif -exp < len(ds):
        fixed = ds[:exp] + "." + ds[exp:]
    else:
        fixed = "0." + "0" * (-exp - len(ds)) + ds
    body = fixed if len(fixed) <= len(sci) else sci
    return "-" + body if sign else body


def write_gct(
    values: np.ndarray,
    path: str,
    row_names: Sequence[str] | None = None,
    col_names: Sequence[str] | None = None,
    descriptions: Sequence[str] | None = None,
) -> None:
    """Write a well-formed GCT v1.2 file (cf. reference ``write.gct``,
    nmf.r:379-408, which duplicates row names into Name and Description —
    kept as the default, with a spec-conformant header)."""
    values = np.atleast_2d(np.asarray(values))
    n_rows, n_cols = values.shape
    if row_names is None:
        row_names = [str(i + 1) for i in range(n_rows)]
    if col_names is None:
        col_names = [str(i + 1) for i in range(n_cols)]
    if descriptions is None:
        descriptions = row_names
    if len(row_names) != n_rows or len(col_names) != n_cols:
        raise ValueError("row/col name lengths do not match matrix shape")
    if len(descriptions) != n_rows:
        raise ValueError("descriptions length does not match matrix rows")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    vals = np.ascontiguousarray(values, dtype=np.float64)
    header = ("#1.2\n" + f"{n_rows}\t{n_cols}\n"
              + "Name\tDescription\t" + "\t".join(map(str, col_names))
              + "\n")
    # C interleaves the name/description prefixes and the formatted
    # values into one buffer, written in binary
    prefs = [f"{name}\t{desc}\t".encode()
             for name, desc in zip(row_names, descriptions)]
    ends = np.cumsum([len(p) for p in prefs], dtype=np.int64)
    body = native.format_gct_body(vals, b"".join(prefs), ends)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(body)


def gct_body_text(values: np.ndarray, row_names: Sequence[str],
                  descriptions: Sequence[str]) -> str:
    """The GCT data block as ``write_gct`` writes it, formatted in Python
    (per value ``_to_chars_double``): the reference the native formatter
    is held to byte for byte."""
    vals = np.ascontiguousarray(np.atleast_2d(values), dtype=np.float64)
    return "".join(
        f"{name}\t{desc}\t" + "\t".join(_to_chars_double(v) for v in row)
        + "\n" for name, desc, row in zip(row_names, descriptions, vals))
