"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and turns it into the sequence of requests a
run sends.

A mix file holds:

* ``argv``: the request's arguments, where ``{name}`` stands for a field;
* ``fields``: how each field is drawn:
  ``{"fixed": v}``; ``{"pool": [...]}`` or ``{"pool_file": path,
  "first": n}`` (lines of a benchmark file), drawn ``"each"`` (every value
  once in each ``len(pool)`` requests, the default) or ``"zipf"`` with
  exponent ``s``; ``{"dirs": [lo, hi]}`` (a corpus directory of depth
  lo..hi, drawn as a pool) or ``{"dirs": "root"}`` (the tree);
* ``target``: the field whose value is the path scanned;
* ``requests``: how many requests one pass of the sequence holds;
* ``draw_seed``: the seed of the draws. Every run gets the same multiset
  of requests, so the same work, and the run's seed only orders it;
  a zipf pool's ranks follow an order shuffled by ``draw_seed``;
* ``warmup_vary``: fields whose every value gets one warm-up request in
  set-up (the rest of the request as the sequence's first, but its target
  the smallest of the target's pool where ``warmup_target`` is
  ``"smallest"``);
* ``check_sample``: how many distinct requests of a run the correctness
  check compares (0 = all), the largest always among them.

The harness drives every mix as a closed loop of one client.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from scanbench.corpus import Corpus

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Request:
    argv: Tuple[str, ...]
    target: str  # the directory or file scanned (absolute)
    nbytes: int  # corpus bytes under the target
    values: Tuple[Tuple[str, str], ...] = ()  # the fields it was made from


def load(name: str) -> dict:
    path = os.path.join(HERE, "traffic", name + ".json")
    with open(path) as f:
        return json.load(f)


def _pool(spec, corpus: Corpus) -> List[str]:
    if "pool" in spec:
        return [str(x) for x in spec["pool"]]
    if "pool_file" in spec:
        with open(os.path.join(HERE, spec["pool_file"]), "rb") as f:
            lines = [ln.decode("utf-8", "surrogateescape") for ln in f.read().splitlines() if ln]
        return lines[: int(spec.get("first", len(lines)))]
    if "dirs" in spec:
        if spec["dirs"] == "root":
            return [corpus.root]
        lo, hi = spec["dirs"]
        return [os.path.join(corpus.root, d) for d in corpus.dirs_at_depth(int(lo), int(hi))]
    if "fixed" in spec:
        return [str(spec["fixed"])]
    raise ValueError(f"unknown field spec {spec}")


def _draw(spec, pool: List[str], n: int, rng: np.random.Generator) -> List[str]:
    if len(pool) == 1:
        return pool * n
    how = spec.get("draw", "each")
    if how == "each":  # every value once per len(pool) requests
        reps = -(-n // len(pool))
        return (pool * reps)[:n]
    if how == "zipf":
        order = rng.permutation(len(pool))
        w = np.arange(1, len(pool) + 1, dtype=np.float64) ** -float(spec["s"])
        picks = rng.choice(len(pool), size=n, p=w / w.sum())
        return [pool[int(order[i])] for i in picks]
    raise ValueError(f"unknown draw {how!r}")


def _fill(argv: List[str], values: Dict[str, str]) -> Tuple[str, ...]:
    out = []
    for a in argv:
        for k, v in values.items():
            a = a.replace("{" + k + "}", v)
        out.append(a)
    return tuple(out)


def _target(mix, values: Dict[str, str], corpus: Corpus) -> Tuple[str, int]:
    target = values[mix["target"]]
    rel = os.path.relpath(target, corpus.root)
    return target, corpus.bytes_under("" if rel == "." else rel)


def _request(mix, values: Dict[str, str], corpus: Corpus) -> Request:
    target, nbytes = _target(mix, values, corpus)
    return Request(_fill(mix["argv"], values), target, nbytes, tuple(sorted(values.items())))


def sequence(mix: dict, corpus: Corpus, seed: int) -> List[Request]:
    """One pass of the run's requests: the mix's fixed multiset, in an
    order drawn from ``seed``."""
    n = int(mix["requests"])
    rng = np.random.default_rng(int(mix["draw_seed"]))
    cols = {k: _draw(spec, _pool(spec, corpus), n, rng) for k, spec in mix["fields"].items()}
    reqs = []
    for i in range(n):
        values = {k: c[i] for k, c in cols.items()}
        reqs.append(_request(mix, values, corpus))
    order = np.random.default_rng([seed, 7]).permutation(n)
    return [reqs[int(i)] for i in order]


def warmups(mix: dict, corpus: Corpus, seq: List[Request]) -> List[Request]:
    """The set-up's requests: the sequence's first, and one for every
    value of each ``warmup_vary`` field with the first request's other
    fields."""
    out = [seq[0]]
    first = dict(seq[0].values)
    if mix.get("warmup_target") == "smallest":
        t = mix["target"]
        pool = _pool(mix["fields"][t], corpus)
        first[t] = min(pool, key=lambda d: _target(mix, dict(first, **{t: d}), corpus)[1])
    for k in mix.get("warmup_vary", []):
        for v in dict.fromkeys(_pool(mix["fields"][k], corpus)):
            req = _request(mix, dict(first, **{k: v}), corpus)
            if req.argv != seq[0].argv:
                out.append(req)
    return out


def patterns_of(req: Request) -> Tuple[List[bytes], bool]:
    """(patterns, literal mode) of a request: ``-H`` reads them from the
    pattern file, one a line."""
    flags, args = [], []
    for a in req.argv:
        if a.startswith("-") and not args and a != "-":
            flags.append(a)
        else:
            args.append(a)
    letters = "".join(f[1:] for f in flags if not f.startswith("--"))
    if set(letters) - set("rRSH"):
        raise ValueError(f"the reference models -r, -S and -H only: {req.argv}")
    literal = "S" in letters
    if "H" in letters:
        with open(args[0], "rb") as f:
            return [ln for ln in f.read().splitlines() if ln], literal
    return [args[0].encode("utf-8", "surrogateescape")], literal
