"""The lint held against what the card reports: sort the host syncs a run
records into the lint's account of them.

A run under `torch.cuda.set_sync_debug_mode("warn")` warns at every
synchronizing CUDA operation; a `SyncRecorder` keeps, for each such
warning, the innermost frame of the linted tree (the port's line that asked for the
sync, wherever torch's own Python sits between).  `classify_site` sorts
each such (file, line) into one of three groups:

  SANCTIONED   inside the hot set, at a line the lint suppresses (an
               inline or def-line `# repro-lint: disable=RPT0xx <reason>`)
  OUTSIDE      outside the hot set: set-up, epilogue, the front door
  UNACCOUNTED  inside the hot set, at a line the lint neither flags nor
               suppresses: a sync no rule sees and no reason accounts for

A site is "at" a line when the line lies in the header of the innermost
statement holding it (a `while` test, say), so a sync raised from a
continuation line of a wrapped call still meets its comment.  Plain
functions, no torch: the tests run them on synthetic records.
"""
from __future__ import annotations

import ast
import collections
import pathlib
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.lint.analysis import FunctionInfo, LintContext, ModuleInfo

SANCTIONED = "sanctioned"
OUTSIDE = "outside"
UNACCOUNTED = "unaccounted"
GROUPS = (SANCTIONED, OUTSIDE, UNACCOUNTED)


def _module_for(ctx: LintContext, path) -> Optional[ModuleInfo]:
    p = pathlib.Path(path)
    resolved = p.resolve() if p.is_absolute() else None
    for mi in ctx.modules.values():
        if resolved is not None:
            if mi.path.resolve() == resolved:
                return mi
        elif mi.rel == p.as_posix() or mi.path.as_posix().endswith("/" + p.as_posix()):
            return mi
    return None


def _innermost_function(mi: ModuleInfo, line: int) -> Optional[FunctionInfo]:
    best = None
    for fi in mi.functions.values():
        if fi.lineno <= line <= fi.end_lineno:
            if best is None or fi.lineno >= best.lineno:
                best = fi
    return best


def _statement_header(mi: ModuleInfo, line: int) -> Tuple[int, int]:
    """(first, last) line of the innermost statement's header holding
    `line`: a simple statement whole, a compound one up to its body."""
    best = None
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.stmt):
            continue
        lo = node.lineno
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            hi = body[0].lineno - 1
        else:
            hi = getattr(node, "end_lineno", lo) or lo
        if lo <= line <= hi and (best is None or lo >= best[0]):
            best = (lo, max(hi, lo))
    return best or (line, line)


def classify_site(ctx: LintContext, path, line: int) -> str:
    """SANCTIONED, OUTSIDE or UNACCOUNTED for a sync raised at `path`
    (absolute, or relative to the lint root) and `line`."""
    mi = _module_for(ctx, path)
    if mi is None:
        return OUTSIDE
    fi = _innermost_function(mi, line)
    if fi is None or fi.key not in ctx.graph.hot:
        return OUTSIDE
    lo, hi = _statement_header(mi, line)
    for ln in range(lo, hi + 1):
        if any(r.startswith("RPT") or r == "all" for r in mi.disabled_rules(ln)):
            return SANCTIONED
    return UNACCOUNTED


def classify_sites(
    ctx: LintContext, sites: Iterable[Tuple[str, int]]
) -> Dict[str, Dict[Tuple[str, int], int]]:
    """{group: {(path, line): count}} over the recorded sites."""
    out: Dict[str, Dict[Tuple[str, int], int]] = {g: {} for g in GROUPS}
    for site, n in collections.Counter(sites).items():
        group = classify_site(ctx, site[0], site[1])
        out[group][site] = n
    return out


def port_frame(root: pathlib.Path, frame, skip: Tuple[pathlib.Path, ...] = ()
               ) -> Optional[Tuple[str, int]]:
    """The innermost frame at or outside `frame` whose file lies under
    `root` (and under none of `skip`): (absolute path, line)."""
    root = root.resolve()
    while frame is not None:
        f = pathlib.Path(frame.f_code.co_filename)
        if f.is_absolute():
            f = f.resolve()
            if root in f.parents and not any(s in f.parents for s in skip):
                return str(f), frame.f_lineno
        frame = frame.f_back
    return None


# what torch's sync debug mode says at every synchronizing operation
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class SyncRecorder:
    """A `warnings.showwarning` stand-in that keeps, for each sync warning
    it is shown, the innermost frame under `root` (or the warning's own
    file and line when there is none), and any other warning's text in
    `others`.  Install it inside `warnings.catch_warnings(record=True)`,
    which restores the original on exit."""

    def __init__(self, root, skip=()):
        self.root = pathlib.Path(root)
        self.skip = tuple(pathlib.Path(s).resolve() for s in skip)
        self.sites: List[Tuple[str, int]] = []
        self.others: List[str] = []

    def __call__(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE not in str(message):
            self.others.append(str(message))
            return
        site = port_frame(self.root, sys._getframe(1), self.skip)
        self.sites.append(site if site is not None else (str(filename), lineno))
