"""Streaming graph ingestion and the delta file format (counterpart of
`repro.dyngraph.stream`).

`iter_edges` opens a graph file, sniffs its format (`detect_format`: a
content marker outranks the extension) and yields bounded `(src, dst)`
int64 chunks from the `serve_mis.io` chunk generators, so peak host memory
is one chunk, not the file's line list.  `load_graph_stream` folds the
chunks into `from_edges`: the graph `load_graph` gives for the same file,
with the same content hash, so a streamed graph hits the same plan-cache
entries.

A delta file is line-oriented:

    + u v      add undirected edge (u, v)      (a bare "u v" line adds)
    - u v      remove undirected edge (u, v)
    # ...      comment (as is %)

`load_delta` parses it into a canonical `EdgeDelta`.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Iterator, List, Optional

from repro_torch.device import DeviceLike
from repro_torch.dyngraph.delta import EdgeDelta
from repro_torch.graphs.graph import Graph, from_edges
from repro_torch.serve_mis.io import (
    CHUNKERS,
    DEFAULT_CHUNK_EDGES,
    Chunk,
    GraphParseError,
    _split_ints,
    collect_chunks,
    detect_format,
    resolve_n_nodes,
)


def iter_edges(
    path: str,
    *,
    fmt: Optional[str] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    info: Optional[dict] = None,
) -> Iterator[Chunk]:
    """Stream a graph file as 0-indexed `(src, dst)` int64 chunk pairs.

    `info` (optional dict) receives `fmt`, the detected format, and
    `n_declared`, the vertex count the file declares (MatrixMarket dims,
    the DIMACS `p` line) once the stream reaches it.  Empty chunks are
    dropped; whole-file invariants raise at the end of the stream."""
    if info is None:
        info = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline()
        if fmt is None:
            fmt = detect_format(path, first)
        if fmt not in CHUNKERS:
            raise ValueError(
                f"unknown graph format {fmt!r}; options {sorted(CHUNKERS)}"
            )
        info["fmt"] = fmt
        lines = itertools.chain([first], f) if first else iter(())
        for src, dst in CHUNKERS[fmt](lines, chunk_edges, info):
            if src.size:
                yield src, dst


def load_graph_stream(
    path: str,
    *,
    fmt: Optional[str] = None,
    n_nodes: Optional[int] = None,
    pad_to: Optional[int] = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    device: DeviceLike = "cuda",
) -> Graph:
    """The chunked twin of `serve_mis.io.load_graph`: the same graph, on
    `device`, without the file's line list in host memory."""
    info: dict = {}
    s, d, max_id = collect_chunks(
        iter_edges(path, fmt=fmt, chunk_edges=chunk_edges, info=info)
    )
    n = resolve_n_nodes(info["fmt"], max_id, info.get("n_declared"), n_nodes)
    return from_edges(s, d, n, pad_to=pad_to, device=device)


def parse_delta(lines: Iterable[str]) -> EdgeDelta:
    """`+ u v` / `- u v` lines → canonical `EdgeDelta` (bare pairs add)."""
    add_s: List[int] = []
    add_d: List[int] = []
    rem_s: List[int] = []
    rem_d: List[int] = []
    for lineno, raw in enumerate(lines, start=1):
        line = raw.strip()
        if not line or line.startswith(("#", "%")):
            continue
        if line[0] in "+-":
            op, body = line[0], line[1:]
        else:
            op, body = "+", line
        u, v = _split_ints(body, lineno, 2)
        if u < 0 or v < 0:
            raise GraphParseError(f"line {lineno}: negative vertex id in {line!r}")
        (add_s if op == "+" else rem_s).append(u)
        (add_d if op == "+" else rem_d).append(v)
    return EdgeDelta.make(add_s, add_d, rem_s, rem_d)


def load_delta(path: str) -> EdgeDelta:
    """Parse a delta file (`parse_delta` gives the line format)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_delta(f)
