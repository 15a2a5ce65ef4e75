"""Corpus generators, one module per generator name that a
configuration file names (``"generator"``), and the tree a run scans.

A generator module has ``files(cfg)`` (every file's relative path and
size), ``write_base(cfg, root)`` (the tree's bytes, from the
configuration's ``text_seed``) and ``plants(cfg, seed)`` (the strings a
run's seed writes into it: (relative path, offset, bytes) each).

``prepare`` keeps one tree per configuration in a cache directory of
the checkout: the first run there writes it, and every run restores the
bytes the previous run planted and plants its own. So a run's inputs
are the configuration's text with its seed's plants, the same seed gives
the same bytes, and a run writes a few KiB, not the whole tree.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
JOURNAL = "planted.json"  # the bytes the current plants replaced
MARKER = "complete"  # written once the base tree is whole

Plant = Tuple[str, int, bytes]  # (path relative to the tree, offset, bytes)


@dataclass
class Corpus:
    root: str  # absolute path of the tree's top
    files: List[Tuple[str, int]]  # (path relative to root, bytes)
    planted: Dict[str, int] = field(default_factory=dict)  # text -> times planted
    _dir_bytes: Optional[Dict[str, int]] = field(default=None, repr=False, compare=False)

    @property
    def total_bytes(self) -> int:
        return sum(s for _, s in self.files)

    def bytes_under(self, rel_dir: str) -> int:
        """Bytes of the files under ``rel_dir`` ("" = the whole tree)."""
        if self._dir_bytes is None:
            acc: Dict[str, int] = {}
            for p, s in self.files:
                parts = p.split("/")
                for d in range(len(parts)):
                    key = "/".join(parts[:d])
                    acc[key] = acc.get(key, 0) + s
            self._dir_bytes = acc
        return self._dir_bytes.get(rel_dir.rstrip("/"), 0)

    def dirs_at_depth(self, lo: int, hi: int) -> List[str]:
        """Directories (relative, sorted) holding files at any depth
        below them, whose own depth is in [lo, hi]; a top-level
        directory has depth 1."""
        out = set()
        for p, _ in self.files:
            parts = p.split("/")[:-1]
            for d in range(lo, min(hi, len(parts)) + 1):
                out.add("/".join(parts[:d]))
        return sorted(out)


def generator(name: str):
    """The generator module named by a configuration."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {name!r}")
    if not os.path.exists(os.path.join(HERE, name + ".py")):
        raise FileNotFoundError(f"no generator {name}.py in {HERE}")
    return importlib.import_module(f"scanbench.corpus.{name}")


def _key(cfg: dict, gen) -> str:
    """What the base tree is made from: the configuration and the code
    that writes it."""
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for path in (gen.__file__, os.path.join(HERE, "textgen.py")):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _by_file(tree: str, edits: Sequence[Plant], each) -> list:
    """``each(fd, [(offset, bytes), ...])`` for every file the edits
    touch, in their order within a file, over a few threads (a file
    operation releases the interpreter lock); the results in the
    order of the files' first edits."""
    groups: Dict[str, List[Tuple[int, bytes]]] = {}
    for rel, pos, data in edits:
        groups.setdefault(rel, []).append((pos, data))

    def one(rel):
        fd = os.open(os.path.join(tree, rel), os.O_RDWR)
        try:
            return each(fd, groups[rel])
        finally:
            os.close(fd)

    with ThreadPoolExecutor(max_workers=8) as ex:
        return list(zip(groups, ex.map(one, groups)))


def _pwrite_all(tree: str, edits: Sequence[Plant]) -> None:
    _by_file(tree, edits, lambda fd, es: [os.pwrite(fd, data, pos) for pos, data in es])


def _restore(tree: str, journal: str) -> None:
    """Put back the bytes the previous run's plants replaced (read from
    the base tree before any was written, so restored in reverse)."""
    with open(journal) as f:
        saved = json.load(f)
    _pwrite_all(tree, [(rel, pos, bytes.fromhex(h)) for rel, pos, h in reversed(saved)])
    os.remove(journal)


def _plant(tree: str, journal: str, plants: Sequence[Plant]) -> None:
    """Save the bytes the plants replace, then write them."""
    read = _by_file(tree, plants, lambda fd, es: [(pos, os.pread(fd, len(data), pos).hex()) for pos, data in es])
    _write_json(journal, [(rel, pos, h) for rel, saved in read for pos, h in saved])
    _pwrite_all(tree, plants)


def prepare(cfg: dict, seed: int, cache_dir: str) -> Corpus:
    """The configuration's tree with ``seed``'s plants, under
    ``cache_dir``: written whole where it is missing or was made from
    another configuration or generator, otherwise only re-planted."""
    gen = generator(cfg["generator"])
    files = gen.files(cfg)
    name = f"{cfg['name']}-{_key(cfg, gen)}"
    home = os.path.join(cache_dir, name)
    tree = os.path.join(home, "tree")
    journal = os.path.join(home, JOURNAL)
    if not os.path.exists(os.path.join(home, MARKER)):
        if os.path.isdir(cache_dir):
            for old in os.listdir(cache_dir):  # this configuration's older trees
                if old.rsplit("-", 1)[0] == cfg["name"]:
                    shutil.rmtree(os.path.join(cache_dir, old), ignore_errors=True)
        os.makedirs(tree)
        gen.write_base(cfg, tree)
        os.sync()  # its write-back stays out of the runs' windows
        _write_json(os.path.join(home, MARKER), {"config": cfg["name"], "files": len(files)})
    elif os.path.exists(journal):
        _restore(tree, journal)
    plants = gen.plants(cfg, seed)
    _plant(tree, journal, plants)
    planted = Counter(data.decode("utf-8", "surrogateescape") for _, _, data in plants)
    return Corpus(root=tree, files=list(files), planted=dict(planted))
