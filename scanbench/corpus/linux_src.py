"""A tree shaped like a Linux v6.x source tree, of C-like ASCII lines.

Shape (paths and sizes, from the configuration's ``shape_seed``):
top-level directories weighted by bytes, about ``dirs`` directories 1 to
``max_depth`` levels deep, ``files`` files with log-normal sizes (median
``median_file_bytes``) scaled to ``total_bytes``. Bytes (from its
``text_seed``): every file is a slice of one text made from a pool of
C-like lines over a fixed identifier vocabulary. Plants (from the run's
seed): the configuration's ``plants`` in a few files each, at their
first byte, their last bytes, across a 512-byte block boundary or
anywhere.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

from scanbench.corpus.textgen import PLACES, plant_position, pool_arrays, text_from_pool, write_tree

PARTS = (
    "dev priv irq buf len ctx reg dma pci eth phy clk mutex lock init exit probe remove read "
    "write val addr count flags state queue work timer page node list entry data info ops cfg "
    "mode port link rx tx skb net sock file inode mm vma task sched cpu mem map alloc free get "
    "put set reset enable disable start stop open close update handle event status error size "
    "index table ring desc hw fw mac ip tcp udp usb i2c spi gpio pm acpi of drm crtc plane fb bo "
    "gem ctrl host bus chan intr stats mask shift offset base id type name seq iter attr group "
    "pool cache hash key sg req resp msg cmd wait done ref kref bio blk disk sector vif sta bss "
    "ssid band rate"
).split()
TYPES = "int u8 u16 u32 u64 bool long void size_t char".split()
ERRS = "EINVAL ENOMEM EIO EBUSY ENODEV EAGAIN ENOSPC ETIMEDOUT".split()
TEMPLATES = (
    "{ind}{id} = {id}({id}, {num});",
    "{ind}if ({id}->{id} & {MAC})",
    "{ind}return {id};",
    "{ind}return -{ERR};",
    "#define {MAC}\t{num}\t/* {w} {w} */",
    "#define {MAC}({id})\t(({id}) << {small})",
    "static int {id}(struct {id} *{id}, {typ} {id})",
    "{ind}}}",
    "{{",
    " * {w} {w} {w} {w} {w}.",
    "{ind}{id}({id}, {id});",
    "#include <linux/{id}.h>",
    "{ind}.{id} = {id},",
    "{ind}struct {id} *{id} = {id}->{id};",
    "{ind}for ({id} = 0; {id} < {MAC}; {id}++)",
    "{ind}{typ} {id};",
    "",
)
DEPTH_SHARE = (0.0, 0.08, 0.30, 0.35, 0.19, 0.08)  # directories at depth 1..6 below a top
EXTS = (".c", ".c", ".c", ".h", ".h", ".S", "", ".txt", ".rst", ".yaml")


def vocabulary(cfg) -> List[str]:
    """The identifiers in Zipf rank order, the held-out ones excluded
    (they are never written)."""
    rng = random.Random(cfg["vocab_seed"])
    held = set(cfg["held_out"])
    seen, out = set(), []
    while len(out) < cfg["identifiers"]:
        k = rng.choice((1, 2, 2, 2, 3, 3))
        ident = "_".join(rng.choice(PARTS) for _ in range(k))
        if ident not in seen and ident not in held:
            seen.add(ident)
            out.append(ident)
    return out


def files(cfg) -> List[Tuple[str, int]]:
    """(relative path, size) of every file, in no particular order."""
    rng = np.random.default_rng(cfg["shape_seed"])
    tops = list(cfg["top_dirs"])
    w = np.array([cfg["top_dirs"][t] for t in tops], dtype=np.float64)
    w /= w.sum()
    max_depth = int(cfg["max_depth"])
    share = np.array(DEPTH_SHARE[:max_depth], dtype=np.float64)
    share /= share.sum()
    dirs_of: Dict[str, List[str]] = {}
    for t, wt in zip(tops, w):
        n = max(1, int(round(cfg["dirs"] * wt)))
        levels = [[t]]
        for d in range(1, max_depth):
            k = int(round((n - 1) * share[d])) if n > 1 else 0
            if k == 0 or not levels[-1]:
                break
            parents = rng.integers(0, len(levels[-1]), size=k)
            names = [f"{PARTS[int(i)]}{j}" for j, i in enumerate(rng.integers(0, len(PARTS), size=k))]
            levels.append([f"{levels[-1][p]}/{nm}" for p, nm in zip(parents, names)])
        dirs_of[t] = [d for lv in levels for d in lv]
    n_files = int(cfg["files"])
    sizes = rng.lognormal(np.log(cfg["median_file_bytes"]), cfg["sigma"], size=n_files)
    sizes = np.clip(sizes, cfg["min_file_bytes"], cfg["max_file_bytes"])
    sizes = np.maximum(np.round(sizes * (cfg["total_bytes"] / sizes.sum())), cfg["min_file_bytes"]).astype(np.int64)
    top_idx = rng.choice(len(tops), size=n_files, p=w)
    pick = rng.random(n_files)
    part = rng.integers(0, len(PARTS), size=n_files)
    ext = rng.integers(0, len(EXTS), size=n_files)
    files = []
    for i in range(n_files):
        ds = dirs_of[tops[top_idx[i]]]
        d = ds[int(pick[i] * len(ds))]
        files.append((f"{d}/{PARTS[part[i]]}_{i}{EXTS[ext[i]]}", int(sizes[i])))
    return files


def line_pool(cfg, seed: int) -> List[bytes]:
    vocab = vocabulary(cfg)
    rng = np.random.default_rng([seed, 1])
    r = random.Random(seed)
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    p = ranks ** -float(cfg["zipf_s"])
    p /= p.sum()
    n = int(cfg["pool_lines"])
    ids = iter(rng.choice(len(vocab), size=n * 8, p=p).tolist())
    macros = ["_".join(r.choice(PARTS).upper() for _ in range(r.choice((2, 3)))) for _ in range(500)]

    def num():
        k = r.random()
        if k < 0.5:
            return str(r.randrange(4096))
        if k < 0.8:
            return hex(r.randrange(1 << 16))
        return "0x%08x" % r.randrange(1 << 32)

    lines = []
    for _ in range(n):
        t = r.choice(TEMPLATES)
        out, i = [], 0
        while True:
            j = t.find("{", i)
            if j < 0:
                out.append(t[i:])
                break
            if t.startswith("{{", j):
                out.append(t[i:j] + "{")
                i = j + 2
                continue
            k = t.index("}", j)
            out.append(t[i:j])
            key = t[j + 1 : k]
            out.append({
                "ind": lambda: "\t" * r.randrange(4),
                "id": lambda: vocab[next(ids)],
                "num": num,
                "small": lambda: str(r.randrange(32)),
                "MAC": lambda: r.choice(macros),
                "ERR": lambda: r.choice(ERRS),
                "typ": lambda: r.choice(TYPES),
                "w": lambda: r.choice(PARTS),
            }[key]())
            i = k + 1
        lines.append("".join(out).replace("}}", "}").encode() + b"\n")
    return lines


def write_base(cfg, root: str) -> None:
    """Every file: a slice, at an offset of its own, of one text made
    from the line pool."""
    tree = files(cfg)
    seed = int(cfg["text_seed"])
    rng = np.random.default_rng([seed, 2])
    base = text_from_pool(rng, pool_arrays(line_pool(cfg, seed)), int(cfg["base_bytes"]))
    offs = rng.integers(0, base.size - int(cfg["max_file_bytes"]), size=len(tree))
    write_tree(root, ((p, memoryview(base[o : o + s])) for o, (p, s) in zip(offs, tree)))


def plants(cfg, seed: int) -> List[Tuple[str, int, bytes]]:
    """Each of the configuration's ``plants`` in one file in
    ``one_file_in``, the files and places drawn from ``seed``."""
    tree = files(cfg)
    rng = np.random.default_rng([seed, 2])
    out = []
    for spec in cfg["plants"]:
        text = spec["text"].encode()
        ok = [i for i, (_, s) in enumerate(tree) if s > len(text)]
        k = min(len(ok), max(1, round(len(tree) / spec["one_file_in"])))
        for j, i in enumerate(rng.choice(ok, size=k, replace=False).tolist()):
            rel, size = tree[i]
            out.append((rel, plant_position(rng, size, len(text), PLACES[j % len(PLACES)]), text))
    return out
