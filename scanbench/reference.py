"""Plain reference of what ``grab -r`` prints: the emit loop of greppin's
FileGrep::find (src/grab.cc:131-239), over Python ``re`` and numpy.

It imports nothing of the program and takes nothing the program made:
it walks the tree, reads the files and searches them itself. The emit
loop is a copy of the repository's independent test oracle
(``tests/oracle.py``) without its imports of the JAX package; the
pattern's minimum length comes from Python's own regex parser.

Semantics held: the sorted physical walk (regular files only, a
directory's files before its subdirectories), the whole-file prune
(minimum length > size), 1 GiB chunks with a 4 KiB overlap, the restart
after the printed after-context, 511-byte context caps stopping at a
newline, ``path:`` before every match of a recursive scan, and for a
``-H`` batch the leftmost match of any pattern, ties to the earlier
pattern. Under PCRE1 a pattern with a capturing group never matches
(grab's 3-slot ovector).

Speed: every pattern's match starts in a file are found at once, not by
one ``re.search`` per step. Literals of 4 bytes or more go through one
numpy hash filter of their first 4 bytes, checked exactly afterwards.
Another pattern is cut at a run of single-byte classes that every match
holds at a bounded offset from its start; the run's positions come
from numpy, and ``re.match`` checks each start they allow. A pattern
with no such run is searched with ``re.search`` from each start found.

``control=True`` breaks one guarantee on purpose (the correctness
check's control): a match that crosses a 512-byte block boundary of
its file is not seen, as a block-local scan without carry would miss
it.
"""

from __future__ import annotations

import os
import re
import stat as stat_mod
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from re import _compiler as sre_compile
from re import _parser as sre_parse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CAP = 511
OVERLAP = 0x1000
CHUNK = 1 << 30
BLOCK = 512
HASH_MUL = 0x9E3779B1
BATCH_BYTES = 4 << 20  # a worker's task: files in walk order up to this many bytes
BATCH_FILES = 2000  # or this many files


class Pattern:
    def __init__(self, text: bytes, literal: bool):
        self.rx = re.compile(re.escape(text) if literal else text)
        self.never = (not literal) and self.rx.groups > 0  # PCRE1's 3-slot ovector
        parsed = sre_parse.parse(self.rx.pattern)
        self.min_len = int(parsed.getwidth()[0])
        self.lit: Optional[bytes] = text if literal else _as_literal(parsed)
        self.run = None if self.lit is not None else _anchor_run(parsed)


def _as_literal(parsed) -> Optional[bytes]:
    if all(op is sre_parse.LITERAL for op, _ in parsed):
        return bytes(av for _, av in parsed)
    return None


def _class_table(state, item) -> np.ndarray:
    rx = sre_compile.compile(sre_parse.SubPattern(state, [item]), 0)
    return np.array([rx.fullmatch(bytes([b])) is not None for b in range(256)])


def _single(state, item) -> Optional[np.ndarray]:
    op, _ = item
    if op in (sre_parse.LITERAL, sre_parse.NOT_LITERAL, sre_parse.IN, sre_parse.ANY):
        return _class_table(state, item)
    return None


def _anchor_run(parsed):
    """(classes, min offset, max offset, exact): a run of single-byte
    classes that every match holds, starting between the two offsets
    from the match's start; ``exact`` when the run is the whole pattern.
    None when no run has a bounded offset."""
    state = parsed.state
    runs = []
    cur, cur_lo, cur_hi = [], 0, 0
    lo, hi = 0, 0

    def close():
        if cur:
            runs.append((list(cur), cur_lo, cur_hi))

    items = list(parsed)
    simple = True  # every item one byte class, or a fixed count of one
    for item in items:
        op, av = item
        t = _single(state, item)
        if t is not None:
            if not cur:
                cur_lo, cur_hi = lo, hi
            cur.append(t)
            lo, hi = lo + 1, hi + 1
            continue
        if op in (sre_parse.MAX_REPEAT, sre_parse.MIN_REPEAT) and len(av[2]) == 1:
            mn, mx, sub = av
            t = _single(state, sub[0])
            if t is not None:
                simple = simple and mn == mx
                if mn:
                    if not cur:
                        cur_lo, cur_hi = lo, hi
                    cur.extend([t] * mn)
                if mx != mn:
                    close()
                    cur = []
                lo += mn
                hi = hi + mx if mx != sre_parse.MAXREPEAT else None
                if hi is None:
                    break
                continue
        simple = False
        close()
        cur = []
        w_lo, w_hi = sre_parse.SubPattern(state, [item]).getwidth()
        lo += w_lo
        if w_hi >= sre_parse.MAXWIDTH:
            break
        hi += w_hi
    else:
        close()
    if not runs:
        return None

    def score(r):
        return sum(float(np.log(256.0 / max(1, int(c.sum())))) for c in r[0])

    best = max(runs, key=score)
    exact = simple and len(runs) == 1 and best[1] == 0 and best[2] == 0
    return best[0], best[1], best[2], exact


def _run_positions(v: np.ndarray, classes: List[np.ndarray], counts: np.ndarray) -> np.ndarray:
    """Positions q where classes[j] holds byte v[q + j] for every j;
    ``counts``: how often each byte value occurs in ``v``, to start from
    the rarest class."""
    k, n = len(classes), v.size
    if n < k:
        return np.zeros(0, dtype=np.int64)
    j0 = int(np.argmin([int(counts[c].sum()) for c in classes]))
    c0 = classes[j0]
    hit = (v == int(np.flatnonzero(c0)[0])) if int(c0.sum()) == 1 else c0[v]
    q = np.flatnonzero(hit) - j0
    q = q[(q >= 0) & (q + k <= n)]
    for j, c in enumerate(classes):
        if j != j0 and q.size:
            q = q[c[v[q + j]]]
    return q


def literal_starts(data, v: np.ndarray, lits: Sequence[bytes]) -> List[np.ndarray]:
    """Every start of every literal (4 bytes or more) in ``data``: for a
    few literals ``bytes.find``; for more, the positions whose first 4
    bytes hash into the literals' table, then an exact check."""
    if len(lits) <= 2:
        out = []
        for lit in lits:
            found, p = [], data.find(lit)
            while p >= 0:
                found.append(p)
                p = data.find(lit, p + 1)
            out.append(np.array(found, dtype=np.int64))
        return out
    keys = np.array([int.from_bytes(x[:4], "little") for x in lits], dtype=np.uint64)
    table = np.zeros(1 << 16, dtype=bool)
    table[((keys * HASH_MUL) & 0xFFFFFFFF) >> 16] = True
    n = v.size
    cands = []
    for a in range(4):
        m = (n - a) // 4
        if m <= 0:
            continue
        w = np.frombuffer(data, dtype="<u4", count=m, offset=a)
        h = (w * np.uint32(HASH_MUL)) >> np.uint32(16)
        cands.append(np.flatnonzero(table[h]) * 4 + a)
    out: List[List[int]] = [[] for _ in lits]
    if not cands:
        return [np.zeros(0, dtype=np.int64) for _ in lits]
    cand = np.sort(np.concatenate(cands))
    w4 = (v[cand].astype(np.uint64) | v[cand + 1].astype(np.uint64) << 8
          | v[cand + 2].astype(np.uint64) << 16 | v[cand + 3].astype(np.uint64) << 24)
    keep = np.isin(w4, keys)
    by_key: Dict[int, List[int]] = {}
    for i, k in enumerate(keys.tolist()):
        by_key.setdefault(k, []).append(i)
    for p, k in zip(cand[keep].tolist(), w4[keep].tolist()):
        for i in by_key[k]:
            if data.startswith(lits[i], p):
                out[i].append(p)
    return [np.array(x, dtype=np.int64) for x in out]


def pattern_matches(pat: Pattern, data, v: np.ndarray, end: int,
                    counts: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the pattern's match at every position where one
    starts, each ending at or before ``end``; a non-literal pattern's
    candidates are checked with ``re.match``. ``counts``: a byte
    histogram of (a sample of) ``v[:end]``, which orders the work only."""
    rx = pat.rx
    if pat.never:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if pat.run is None:
        s, e, pos = [], [], 0
        while True:
            m = rx.search(data, pos, end)
            if m is None:
                break
            s.append(m.start())
            e.append(m.end())
            pos = m.start() + 1
        return np.array(s, dtype=np.int64), np.array(e, dtype=np.int64)
    classes, lo, hi, exact = pat.run
    if counts is None:
        counts = np.bincount(v[:end:61], minlength=256)
    q = _run_positions(v[:end], classes, counts)
    if exact:
        return q, q + len(classes)
    starts = np.unique(np.concatenate([q - d for d in range(lo, hi + 1)])) if q.size else q
    s, e = [], []
    for p in starts[starts >= 0].tolist():
        m = rx.match(data, p, end)
        if m is not None:
            s.append(p)
            e.append(m.end())
    return np.array(s, dtype=np.int64), np.array(e, dtype=np.int64)


def file_output(path: str, data: bytes, pats: Sequence[Pattern], recursive: bool = True,
                control: bool = False, chunk: int = CHUNK) -> bytes:
    """What grab prints for one file (``chunk``: grab's chunk size)."""
    size = len(data)
    min_len = min(p.min_len for p in pats)
    if min_len > size or all(p.never for p in pats):
        return b""
    v = np.frombuffer(data, dtype=np.uint8)
    lits = [(i, p.lit) for i, p in enumerate(pats) if p.lit is not None and len(p.lit) >= 4 and not p.never]
    whole: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if lits:
        for (i, lit), st in zip(lits, literal_starts(data, v, [x for _, x in lits])):
            whole[i] = (st, st + len(lit))
    path_b = path.encode("utf-8", "surrogateescape")
    out = bytearray()
    stride = chunk - OVERLAP
    off = 0
    while off < size:
        end = min(off + chunk, size)
        found = []
        counts = np.bincount(v[:end:61], minlength=256) if len(whole) < len(pats) else None
        for i, p in enumerate(pats):
            if i in whole:
                s, e = whole[i]
                sel = (s >= off) & (e <= end)
                s, e = s[sel], e[sel]
            else:
                s, e = pattern_matches(p, data, v, end, counts)
                sel = s >= off
                s, e = s[sel], e[sel]
            if control:
                keep = s // BLOCK == (e - 1) // BLOCK
                s, e = s[keep], e[keep]
            found.append((s, e))
        buf = _emit_chunk(path_b, data, off, end, min_len, found, recursive)
        out += buf
        off += stride
    return bytes(out)


def _emit_chunk(path_b, data, off, end, min_len, found, recursive) -> bytearray:
    buf = bytearray()
    start = off
    while start + min_len < end:
        best = None
        for s, e in found:
            k = int(np.searchsorted(s, start))
            if k < len(s) and (best is None or s[k] < best[0]):
                best = (int(s[k]), int(e[k]))
        if best is None:
            break
        ms, me = best
        if recursive:
            buf += path_b + b":"
        floor = max(start, ms - CAP)
        nl = data.rfind(b"\n", floor, ms)
        b0 = nl + 1 if nl >= 0 else floor
        lim = min(end, me + CAP)
        nl = data.find(b"\n", me, lim)
        ae = nl if nl >= 0 else lim
        buf += data[b0:ae] + b"\n"
        new_start = ae
        if new_start == start:
            new_start += 1
        start = new_start
    return buf


def walk(root: str) -> List[Tuple[str, int]]:
    """(path, size) of the regular files under ``root`` in grab's order:
    sorted names, a directory's files before its subdirectories,
    symbolic links not followed."""
    st = os.lstat(root)
    if stat_mod.S_ISREG(st.st_mode):
        return [(root, st.st_size)]
    out, stack = [], [root]
    while stack:
        d = stack.pop()
        subdirs = []
        for ent in sorted(os.scandir(d), key=lambda e: e.name):
            est = ent.stat(follow_symlinks=False)
            if stat_mod.S_ISREG(est.st_mode):
                out.append((ent.path, est.st_size))
            elif stat_mod.S_ISDIR(est.st_mode):
                subdirs.append(ent.path)
        stack.extend(reversed(subdirs))
    return out


_PATTERNS: Dict[tuple, List[Pattern]] = {}  # per process: patterns built once


def _file_job(args) -> bytes:
    path, patterns, literal, control = args
    key = (tuple(patterns), literal)
    pats = _PATTERNS.get(key)
    if pats is None:
        pats = _PATTERNS[key] = [Pattern(p, literal) for p in patterns]
    with open(path, "rb") as f:
        data = f.read()
    return file_output(path, data, pats, control=control)


def _batch_job(jobs) -> List[bytes]:
    return [_file_job(j) for j in jobs]


def tree_outputs(requests: Sequence[Tuple[str, Sequence[bytes], bool]], workers: int = 1,
                 control: bool = False) -> List[bytes]:
    """The expected stdout of each (root, patterns, literal mode)
    request, file by file over ``workers`` processes: a large file a
    task, small files in runs of about ``BATCH_BYTES`` (a task costs more
    than a small file)."""
    jobs, spans, sizes = [], [], []
    for root, patterns, literal in requests:
        files = walk(root)
        spans.append((len(jobs), len(jobs) + len(files)))
        jobs.extend((p, list(patterns), literal, control) for p, _ in files)
        sizes.extend(s for _, s in files)
    batches, cur, cur_bytes = [], [], 0
    for i, s in enumerate(sizes):
        cur.append(i)
        cur_bytes += s
        if cur_bytes >= BATCH_BYTES or len(cur) >= BATCH_FILES:
            batches.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        batches.append(cur)
    res: List[bytes] = [b""] * len(jobs)
    if workers > 1 and len(batches) > 1:
        batches.sort(key=lambda b: -sum(sizes[i] for i in b))
        with ProcessPoolExecutor(max_workers=min(workers, len(batches)), mp_context=get_context("spawn")) as ex:
            for b, outs in zip(batches, ex.map(_batch_job, [[jobs[i] for i in b] for b in batches])):
                for i, o in zip(b, outs):
                    res[i] = o
    else:
        for b in batches:
            for i in b:
                res[i] = _file_job(jobs[i])
    return [b"".join(res[a:b]) for a, b in spans]
