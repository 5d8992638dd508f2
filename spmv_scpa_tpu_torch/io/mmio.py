"""Matrix Market (``.mtx``) I/O with NumPy (counterpart of
``spmv_scpa_tpu/io/mmio.py``, whose parser this copies).

The subset of the format the reference study reads through the NIST
mmio library (src/mmio.c): the banner (mmio.c:93-166), the coordinate
size line (mmio.c:175-200) and the entries (mmio.c:241-342), parsed in
bulk rather than line by line; writing as mm_write does (mmio.c:356-394).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass

import numpy as np

from spmv_scpa_tpu_torch.errors import MatrixFormatError

BANNER_PREFIX = "%%MatrixMarket"

_OBJECTS = ("matrix",)
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern", "complex")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclass(frozen=True)
class MMBanner:
    """Parsed banner typecode (mmio.h:22-47)."""

    object: str
    format: str
    field: str
    symmetry: str

    @property
    def is_sparse(self) -> bool:
        return self.format == "coordinate"

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"

    def __str__(self) -> str:
        return f"{self.object} {self.format} {self.field} {self.symmetry}"


@dataclass
class COOMatrix:
    """Coordinate entries as read from the file: 0-based indices,
    duplicates and symmetric halves not expanded."""

    banner: MMBanner
    nrows: int
    ncols: int
    row: np.ndarray  # int64, 0-based
    col: np.ndarray  # int64, 0-based
    val: np.ndarray | None  # float64, or None for pattern

    @property
    def nnz_stored(self) -> int:
        return int(self.row.shape[0])


def read_banner(line: str) -> MMBanner:
    """Parse the ``%%MatrixMarket`` banner line (mmio.c:93-166)."""
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != BANNER_PREFIX:
        raise MatrixFormatError(f"not a Matrix Market file: banner {line!r}")
    obj, fmt, field, sym = (p.lower() for p in parts[1:5])
    if obj not in _OBJECTS:
        raise MatrixFormatError(f"unsupported MM object {obj!r}")
    if fmt not in _FORMATS:
        raise MatrixFormatError(f"unsupported MM format {fmt!r}")
    if field not in _FIELDS:
        raise MatrixFormatError(f"unsupported MM field {field!r}")
    if sym not in _SYMMETRIES:
        raise MatrixFormatError(f"unsupported MM symmetry {sym!r}")
    return MMBanner(obj, fmt, field, sym)


def _split_header(text: bytes) -> tuple[MMBanner, int, int, int, bytes]:
    """Consume banner, comments and the size line; return the entry
    payload."""
    stream = _io.BytesIO(text)
    first = stream.readline().decode("ascii", errors="replace")
    banner = read_banner(first)
    while True:
        raw = stream.readline()
        if not raw:
            raise MatrixFormatError("missing size line")
        line = raw.decode("ascii", errors="replace").strip()
        if not line or line.startswith("%"):
            continue
        break
    sizes = line.split()
    if banner.format == "coordinate":
        if len(sizes) != 3:
            raise MatrixFormatError(f"bad coordinate size line: {line!r}")
        nrows, ncols, nnz = (int(s) for s in sizes)
    else:
        if len(sizes) != 2:
            raise MatrixFormatError(f"bad array size line: {line!r}")
        nrows, ncols = (int(s) for s in sizes)
        nnz = nrows * ncols
    return banner, nrows, ncols, nnz, stream.read()


# Byte window per parse chunk: bounds the transient token list so a
# multi-GB payload never holds all its tokens at once.
_PARSE_CHUNK_BYTES = 16 << 20


def _bulk_parse_numbers(payload: bytes, ncols_per_line: int,
                        nnz: int) -> np.ndarray:
    """Parse whitespace-separated numbers into a (nnz, ncols_per_line)
    float64 array, in byte windows cut at whitespace."""
    want = nnz * ncols_per_line
    out = np.empty(want, dtype=np.float64)
    pos = 0
    ofs = 0
    n = len(payload)
    while ofs < n:
        end = min(ofs + _PARSE_CHUNK_BYTES, n)
        if end < n:
            cut = max(payload.rfind(b"\n", ofs, end),
                      payload.rfind(b" ", ofs, end),
                      payload.rfind(b"\t", ofs, end))
            if cut >= 0:
                end = cut + 1
            else:  # one window-long token run: extend to the line end
                nxt = payload.find(b"\n", end)
                end = n if nxt < 0 else nxt + 1
        toks = payload[ofs:end].split()
        ofs = end
        if not toks:
            continue
        k = len(toks)
        if pos + k > want:
            raise MatrixFormatError(
                f"trailing tokens: expected {want}, found >= {pos + k}")
        out[pos:pos + k] = np.array(toks, dtype=np.float64)
        pos += k
    if pos < want:
        raise MatrixFormatError(
            f"file truncated: expected {want} tokens, found {pos}")
    return out.reshape(nnz, ncols_per_line)


def read(path_or_bytes) -> COOMatrix:
    """Read a Matrix Market file (a path or raw ``bytes``) into a
    :class:`COOMatrix`. Dense ``array`` and ``complex`` files raise, as
    the reference study accepts sparse real/pattern input only
    (csr.c:48-52)."""
    if isinstance(path_or_bytes, bytes):
        text = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            text = f.read()
    banner, nrows, ncols, nnz, payload = _split_header(text)

    if banner.format != "coordinate":
        raise MatrixFormatError(
            "dense 'array' Matrix Market files are not supported "
            "(reference accepts only sparse input, csr.c:48-52)")
    if banner.field == "complex":
        raise MatrixFormatError(
            "complex matrices are not supported "
            "(reference accepts real/pattern only, csr.c:48-52)")

    if banner.field == "pattern":
        table = _bulk_parse_numbers(payload, 2, nnz)
        val = None
    else:
        table = _bulk_parse_numbers(payload, 3, nnz)
        val = np.ascontiguousarray(table[:, 2], dtype=np.float64)
    row = table[:, 0].astype(np.int64) - 1
    col = table[:, 1].astype(np.int64) - 1
    return COOMatrix(banner, nrows, ncols, row, col, val)


def write(path, nrows: int, ncols: int, row, col, val=None,
          symmetry: str = "general", comment: str | None = None) -> None:
    """Write a coordinate Matrix Market file (mmio.c:356-394). Indices
    are 0-based in memory, 1-based on disk."""
    row = np.asarray(row)
    col = np.asarray(col)
    field = "pattern" if val is None else "real"
    with open(path, "w") as f:
        f.write(f"{BANNER_PREFIX} matrix coordinate {field} {symmetry}\n")
        if comment:
            for ln in comment.splitlines():
                f.write(f"% {ln}\n")
        f.write(f"{nrows} {ncols} {row.shape[0]}\n")
        if val is None:
            for r, c in zip(row, col):
                f.write(f"{int(r) + 1} {int(c) + 1}\n")
        else:
            val = np.asarray(val, dtype=np.float64)
            for r, c, v in zip(row, col, val):
                f.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")
