"""Graph file ingestion: SNAP edge lists, MatrixMarket and DIMACS →
`graphs.Graph` (counterpart of `repro.serve_mis.io`; the same parsers, the
same `GraphParseError`s, the same graphs).

Formats:

  edge list   one `u v` pair per line (SNAP / Konect style); `#` and `%`
              comment lines skipped; extra columns ignored; vertex ids kept
              as they are, with ``n_nodes = max_id + 1`` unless overridden.
  .mtx        MatrixMarket `coordinate` (pattern/real/integer, general or
              symmetric), 1-indexed, values ignored.  Array (dense)
              MatrixMarket files are rejected.
  DIMACS      `c` comments, `p edge|col N M` header, `e u v` edge lines,
              1-indexed.

Parsing is host numpy and total: every malformed line raises
`GraphParseError` with its line number.  Each format has one line-level
implementation, its `iter_*_chunks` generator of bounded `(src, dst)`
int64 chunks; the whole-file `parse_*` functions collect those chunks, and
`repro_torch.dyngraph.stream` reads the same generators.  `load_graph`
builds the canonical graph (`from_edges`) on `device`, the CUDA device
unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import Graph, from_edges

DEFAULT_CHUNK_EDGES = 1 << 16

Chunk = Tuple[np.ndarray, np.ndarray]   # (src, dst) int64, equal length


class GraphParseError(ValueError):
    """A graph file violated its format contract."""


_EXT_FORMATS = {
    ".mtx": "mtx",
    ".mm": "mtx",
    ".dimacs": "dimacs",
    ".col": "dimacs",
    ".clq": "dimacs",
    ".edges": "edgelist",
    ".el": "edgelist",
    ".txt": "edgelist",
    ".tsv": "edgelist",
    ".csv": "edgelist",
}


def detect_format(path: str, first_line: str = "") -> str:
    """Format detection: unambiguous content markers outrank the extension.

    The MatrixMarket banner and a DIMACS `c`/`p` head are mandatory in their
    formats and illegal in an edge list, so a `.txt`-named `.mtx` file must
    not be silently mis-parsed as an edge list; extensions only decide when
    the first line is not self-identifying.
    """
    head = first_line.strip().lower()
    if head.startswith("%%matrixmarket"):
        return "mtx"
    if head.startswith(("c ", "p ")) or head in ("c", "p"):
        return "dimacs"
    return _EXT_FORMATS.get(os.path.splitext(path)[1].lower(), "edgelist")


def _split_ints(line: str, lineno: int, want: int) -> List[int]:
    parts = line.replace(",", " ").split()
    if len(parts) < want:
        raise GraphParseError(f"line {lineno}: expected {want} fields, got {line!r}")
    try:
        # strict int(): '1.9' or float-precision-losing 64-bit ids must be a
        # parse error, not a silently truncated vertex id
        return [int(p) for p in parts[:want]]
    except ValueError as e:
        raise GraphParseError(f"line {lineno}: non-integer field in {line!r}") from e


# --------------------------------------------------------------------------
# the line-level implementations: one chunked generator per format
# --------------------------------------------------------------------------


class _ChunkBuf:
    """Accumulate (u, v) pairs, flush as int64 array pairs every `cap`."""

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self.src: List[int] = []
        self.dst: List[int] = []

    def push(self, u: int, v: int) -> bool:
        self.src.append(u)
        self.dst.append(v)
        return len(self.src) >= self.cap

    def flush(self) -> Chunk:
        out = (np.asarray(self.src, np.int64), np.asarray(self.dst, np.int64))
        self.src, self.dst = [], []
        return out


def iter_edgelist_chunks(
    lines: Iterable[str],
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    info: Optional[dict] = None,
) -> Iterator[Chunk]:
    """SNAP-style `u v` lines → 0-indexed (src, dst) chunk pairs."""
    del info   # edge lists declare no vertex count
    buf = _ChunkBuf(chunk_edges)
    for lineno, raw in enumerate(lines, start=1):
        line = raw.strip()
        if not line or line.startswith(("#", "%")):
            continue
        u, v = _split_ints(line, lineno, 2)
        if u < 0 or v < 0:
            raise GraphParseError(f"line {lineno}: negative vertex id in {line!r}")
        if buf.push(u, v):
            yield buf.flush()
    yield buf.flush()


def iter_mtx_chunks(
    lines: Iterable[str],
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    info: Optional[dict] = None,
) -> Iterator[Chunk]:
    """MatrixMarket coordinate lines → 0-indexed chunk pairs (values
    dropped).  `info['n_declared']` receives max(rows, cols) once the size
    line is reached."""
    info = {} if info is None else info
    it = iter(enumerate(lines, start=1))
    try:
        lineno, header = next(it)
    except StopIteration:
        raise GraphParseError("empty MatrixMarket file")
    fields = header.strip().lower().split()
    if not fields or fields[0] != "%%matrixmarket":
        raise GraphParseError(f"line {lineno}: missing %%MatrixMarket banner")
    if "coordinate" not in fields:
        raise GraphParseError("only sparse `coordinate` MatrixMarket is supported")
    dims: Optional[Tuple[int, int, int]] = None
    seen = 0
    buf = _ChunkBuf(chunk_edges)
    for lineno, raw in it:
        line = raw.strip()
        if not line or line.startswith("%"):
            continue
        if dims is None:
            rows, cols, nnz = _split_ints(line, lineno, 3)
            dims = (rows, cols, nnz)
            info["n_declared"] = max(rows, cols)
            continue
        i, j = _split_ints(line, lineno, 2)
        if not (1 <= i <= dims[0] and 1 <= j <= dims[1]):
            raise GraphParseError(
                f"line {lineno}: entry ({i},{j}) outside {dims[0]}x{dims[1]}"
            )
        seen += 1
        if buf.push(i - 1, j - 1):
            yield buf.flush()
    if dims is None:
        raise GraphParseError("MatrixMarket file has no size line")
    if seen != dims[2]:
        raise GraphParseError(f"size line promised {dims[2]} entries, found {seen}")
    yield buf.flush()


def iter_dimacs_chunks(
    lines: Iterable[str],
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    info: Optional[dict] = None,
) -> Iterator[Chunk]:
    """DIMACS `e u v` records → 0-indexed chunk pairs.  `info['n_declared']`
    receives the `p` line's vertex count."""
    info = {} if info is None else info
    n_declared: Optional[int] = None
    buf = _ChunkBuf(chunk_edges)
    for lineno, raw in enumerate(lines, start=1):
        line = raw.strip()
        if not line or line[0] in ("c", "%", "#"):
            continue
        if line[0] == "p":
            parts = line.split()
            if len(parts) < 3:
                raise GraphParseError(f"line {lineno}: malformed problem line {line!r}")
            try:
                n_declared = int(parts[2])
            except ValueError as e:
                raise GraphParseError(
                    f"line {lineno}: non-numeric vertex count in {line!r}"
                ) from e
            info["n_declared"] = n_declared
            continue
        if line[0] == "e":
            u, v = _split_ints(line[1:], lineno, 2)
            if u < 1 or v < 1:
                raise GraphParseError(f"line {lineno}: DIMACS ids are 1-indexed")
            if buf.push(u - 1, v - 1):
                yield buf.flush()
            continue
        raise GraphParseError(f"line {lineno}: unknown DIMACS record {line!r}")
    if n_declared is None:
        raise GraphParseError("DIMACS file has no `p` problem line")
    yield buf.flush()


CHUNKERS = {
    "edgelist": iter_edgelist_chunks,
    "mtx": iter_mtx_chunks,
    "dimacs": iter_dimacs_chunks,
}


def collect_chunks(
    chunks: Iterable[Chunk],
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drain a chunk iterator into whole arrays; returns (src, dst, max_id)
    with max_id = -1 for an edgeless stream.  Shared by the whole-file
    parsers below and `dyngraph.stream.load_graph_stream`."""
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    for s, d in chunks:
        if s.size:
            srcs.append(s)
            dsts.append(d)
    s = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    d = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    return s, d, int(max(s.max(initial=-1), d.max(initial=-1)))


def resolve_n_nodes(
    fmt: str,
    max_id: int,
    declared: Optional[int] = None,
    n_nodes: Optional[int] = None,
) -> int:
    """The per-format vertex-count resolution and its guards, single-sited:
    explicit override > the file's declared count > max_id + 1 — rejecting
    counts the edges overflow and the describes-no-graph case with each
    format's established error message (tests pin the wording)."""
    n = int(n_nodes) if n_nodes is not None else (
        declared if declared is not None else max_id + 1
    )
    if n <= max_id:
        raise GraphParseError({
            "edgelist": f"n_nodes={n} but file references vertex {max_id}",
            "mtx": f"n_nodes={n} but file references vertex {max_id + 1}",
            "dimacs": f"problem line says {n} vertices, file uses {max_id + 1}",
        }[fmt])
    if n < 1:
        raise GraphParseError({
            "edgelist": "edge list contains no edges (and no n_nodes override)",
            "mtx": "MatrixMarket size line declares a 0-vertex matrix",
            "dimacs": "DIMACS problem line declares 0 vertices",
        }[fmt])
    return n


# --------------------------------------------------------------------------
# whole-file parsers: collect chunks + per-format vertex-count resolution
# --------------------------------------------------------------------------


def parse_edge_list(
    lines: Iterable[str], n_nodes: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """SNAP-style `u v` pairs → (src, dst, n_nodes)."""
    s, d, max_id = collect_chunks(iter_edgelist_chunks(lines))
    return s, d, resolve_n_nodes("edgelist", max_id, None, n_nodes)


def parse_mtx(
    lines: Iterable[str], n_nodes: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """MatrixMarket coordinate file → (src, dst, n_nodes); values dropped."""
    info: dict = {}
    s, d, max_id = collect_chunks(iter_mtx_chunks(lines, info=info))
    return s, d, resolve_n_nodes("mtx", max_id, info.get("n_declared"), n_nodes)


def parse_dimacs(
    lines: Iterable[str], n_nodes: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, int]:
    """DIMACS `p edge` file → (src, dst, n_nodes); 1-indexed `e u v` lines."""
    info: dict = {}
    s, d, max_id = collect_chunks(iter_dimacs_chunks(lines, info=info))
    return s, d, resolve_n_nodes(
        "dimacs", max_id, info.get("n_declared"), n_nodes
    )


_PARSERS = {
    "edgelist": parse_edge_list,
    "mtx": parse_mtx,
    "dimacs": parse_dimacs,
}


def load_graph(
    path: str,
    *,
    fmt: Optional[str] = None,
    n_nodes: Optional[int] = None,
    pad_to: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Graph:
    """Parse a graph file into a canonical undirected :class:`Graph` on
    `device`.

    ``fmt`` overrides detection (`edgelist` | `mtx` | `dimacs`); ``n_nodes``
    overrides the file's vertex count; ``pad_to`` pre-pads the edge arrays
    (see `graphs.graph.from_edges`).  Reads the whole file;
    `repro_torch.dyngraph.stream.load_graph_stream` is the bounded-memory
    twin over the same chunk generators.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.readlines()
    if fmt is None:
        fmt = detect_format(path, lines[0] if lines else "")
    if fmt not in _PARSERS:
        raise ValueError(f"unknown graph format {fmt!r}; options {sorted(_PARSERS)}")
    src, dst, n = _PARSERS[fmt](lines, n_nodes)
    return from_edges(src, dst, n, pad_to=pad_to, device=device)
