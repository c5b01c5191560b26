"""Sparse ingestion for atlas-scale inputs (copy of ``nmfx/sparse.py``).

The atlases users submit — million-cell scRNA-seq count matrices — are
more than 90 % zeros, and NMF consumes A only through the Gram-style
contractions WᵀA and AHᵀ (MPI-FAUN, arxiv 1609.09154), so contracting
against the stored nonzeros alone cuts the data-sized work by the
density factor while every k-sized term stays dense. This module is the
host half of that:

* :class:`SparseMatrix` — a minimal CSR container (``indptr``/
  ``indices``/``data`` + ``shape``) in canonical form (row-major,
  column-sorted, explicit zeros dropped), cheap row-block slicing (what
  the tile pipeline in ``nmfx_torch/tiles.py`` streams by), and a
  content fingerprint over the canonical triplets, the same hex string
  as the reference package's for the same matrix.
* :meth:`SparseMatrix.tile_coo` — a row block as row-local COO
  ``(indices, data)``, the reference's tile payload (the port's stream
  ships CSR, ``tiles.TileStream``; the COO form stays for callers and
  tests).

A sparse solve is the same program as the densified one; the agreement
gates (``nmfx_torch/agreement.py``) hold them together at planted
shapes; bit-level identity is not promised (sparse products sum in the
stored-nonzero order).

File loaders (MatrixMarket ``.mtx``, the ``.csr.npz`` bundle) live in
``nmfx_torch/io.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from nmfx_torch.obs import metrics as _metrics

__all__ = ["SparseMatrix", "note_sparse_tile"]

#: stored nonzeros streamed through sparse tile contractions (every tile
#: of every pass counts its stored nnz once)
_sparse_nnz_total = _metrics.counter(
    "nmfx_sparse_nnz_total",
    "stored nonzeros streamed through sparse tile contractions")
_sparse_nnz_bytes_total = _metrics.counter(
    "nmfx_sparse_nnz_bytes_total",
    "bytes of sparse tile payloads (values + indices) transferred "
    "host-to-device")


def note_sparse_tile(nnz: int, nbytes: int) -> None:
    """Book one sparse tile's streamed nonzeros and bytes (called by the
    tile stream, ``nmfx_torch/tiles.py``)."""
    _sparse_nnz_total.inc(nnz)
    _sparse_nnz_bytes_total.inc(nbytes)


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """Host CSR matrix in canonical form.

    Canonical means: ``indptr`` is a monotone ``int64`` array of length
    ``m + 1``; within each row ``indices`` is strictly increasing
    ``int32`` (no duplicates); ``data`` holds no explicit zeros. Both
    constructors (:meth:`from_dense`, :meth:`from_coo`) canonicalize, so
    two representations of the same matrix fingerprint identically."""

    indptr: np.ndarray  # (m + 1,) int64
    indices: np.ndarray  # (nnz,) int32 column indices
    data: np.ndarray  # (nnz,) values
    shape: tuple

    def __post_init__(self):
        m, n = self.shape
        object.__setattr__(self, "shape", (int(m), int(n)))
        indptr = np.ascontiguousarray(self.indptr, np.int64)
        indices = np.ascontiguousarray(self.indices, np.int32)
        data = np.ascontiguousarray(self.data)
        if indptr.shape != (self.shape[0] + 1,):
            raise ValueError(
                f"indptr must have shape ({self.shape[0] + 1},), got "
                f"{indptr.shape}")
        if indptr[0] != 0 or indptr[-1] != len(data):
            raise ValueError("indptr must run [0, ..., nnz]")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("indptr must be monotone non-decreasing")
        if len(indices) != len(data):
            raise ValueError("indices and data must have equal length")
        if len(indices) and (indices.min() < 0
                             or indices.max() >= self.shape[1]):
            raise ValueError("column indices out of range")
        object.__setattr__(self, "indptr", indptr)
        object.__setattr__(self, "indices", indices)
        object.__setattr__(self, "data", data)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dense(cls, a) -> "SparseMatrix":
        """CSR of a dense host array (row-major scan: canonical by
        construction)."""
        a = np.asarray(a)
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {a.shape}")
        rows, cols = np.nonzero(a)
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=cols.astype(np.int32),
                   data=a[rows, cols], shape=a.shape)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "SparseMatrix":
        """CSR from COO triplets: sorts row-major then by column, sums
        duplicate entries (the MatrixMarket convention) and drops entries
        that cancel to exact zero."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        m, n = int(shape[0]), int(shape[1])
        if len(rows) and (rows.min() < 0 or rows.max() >= m
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError("COO indices out of range for shape "
                             f"({m}, {n})")
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if len(rows):
            # sum duplicates: group boundaries where (row, col) changes
            new = np.empty(len(rows), bool)
            new[0] = True
            new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(new) - 1
            vals = np.bincount(group, weights=vals.astype(np.float64),
                               minlength=group[-1] + 1).astype(vals.dtype)
            rows, cols = rows[new], cols[new]
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        indptr = np.zeros(m + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=cols.astype(np.int32),
                   data=vals, shape=(m, n))

    # -- basic queries ------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(len(self.data))

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    @property
    def nbytes(self) -> int:
        return (self.indptr.nbytes + self.indices.nbytes
                + self.data.nbytes)

    def toarray(self, dtype=None) -> np.ndarray:
        """Densify (test shapes and the agreement gates only: densifying
        an atlas defeats the module)."""
        m, n = self.shape
        out = np.zeros((m, n), dtype if dtype is not None
                       else self.data.dtype)
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    # -- tiling -------------------------------------------------------------
    def row_block(self, r0: int, r1: int) -> "SparseMatrix":
        """Rows ``[r0, r1)`` as their own canonical CSR (shares the value
        and index buffers)."""
        p0, p1 = int(self.indptr[r0]), int(self.indptr[r1])
        return SparseMatrix(indptr=self.indptr[r0:r1 + 1] - p0,
                            indices=self.indices[p0:p1],
                            data=self.data[p0:p1],
                            shape=(r1 - r0, self.shape[1]))

    def tile_coo(self, r0: int, r1: int, dtype
                 ) -> "tuple[np.ndarray, np.ndarray]":
        """Rows ``[r0, r1)`` as a row-local COO block: ``indices`` is
        ``(nnz_t, 2) int32`` ``[row - r0, col]`` in canonical order, and
        ``data`` is cast to ``dtype``."""
        p0, p1 = int(self.indptr[r0]), int(self.indptr[r1])
        counts = np.diff(self.indptr[r0:r1 + 1]).astype(np.int64)
        local_rows = np.repeat(np.arange(r1 - r0, dtype=np.int32), counts)
        idx = np.stack([local_rows, self.indices[p0:p1]], axis=1)
        return idx, np.asarray(self.data[p0:p1], dtype)

    def block_sq_norms(self, boundaries) -> np.ndarray:
        """``sum(data**2)`` per ``(r0, r1)`` row block, accumulated in
        float64."""
        sq = (self.data.astype(np.float64) ** 2)
        csum = np.concatenate([[0.0], np.cumsum(sq)])
        return np.asarray([csum[self.indptr[r1]] - csum[self.indptr[r0]]
                           for r0, r1 in boundaries])

    # -- content addressing --------------------------------------------------
    def fingerprint(self) -> str:
        """sha256 over the canonical triplets, the shape and the value
        dtype (content, not identity: an in-place change yields a new
        digest)."""
        h = hashlib.sha256()
        h.update(repr((self.shape, self.data.dtype.str)).encode())
        h.update(np.ascontiguousarray(self.indptr).view(np.uint8))
        h.update(np.ascontiguousarray(self.indices).view(np.uint8))
        h.update(np.ascontiguousarray(self.data).view(np.uint8))
        return h.hexdigest()
