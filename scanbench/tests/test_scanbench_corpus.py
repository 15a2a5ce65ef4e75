"""The corpus generators and the traffic generator: deterministic in the
seed, of the stated shape, at a tiny scale."""

import hashlib
import json
import os

import numpy as np
import pytest

from scanbench import mix as mixmod
from scanbench import reference
from scanbench.corpus import generator, prepare
from scanbench.tests.tiny import ROOT, config


def digest(root):
    h = hashlib.sha256()
    for path, size in reference.walk(root):
        h.update(os.path.relpath(path, root).encode() + b"%d" % size)
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["linux_src", "log_ioc"])
def test_same_seed_same_bytes_other_seed_other_bytes_same_shape(tmp_path, name):
    cfg = config(name)
    a = prepare(cfg, 2**31 + 12345, str(tmp_path / "a"))
    da = digest(a.root)
    assert digest(prepare(cfg, 2**31 + 12345, str(tmp_path / "b")).root) == da
    c = prepare(cfg, 7, str(tmp_path / "c"))
    assert digest(c.root) != da
    assert a.files == c.files  # the shape is the configuration's, not the seed's
    walked = {os.path.relpath(p, a.root): s for p, s in reference.walk(a.root)}
    assert walked == dict(a.files)
    assert sum(a.planted.values()) == len(generator(cfg["generator"]).plants(cfg, 2**31 + 12345))


@pytest.mark.parametrize("name", ["linux_src", "log_ioc"])
def test_kept_tree_replanted_equals_fresh_tree(tmp_path, name):
    """A run in a checkout whose tree an earlier run planted sees the
    bytes a fresh tree would have, and writes no file whole again."""
    cfg = config(name)
    cache = str(tmp_path / "kept")
    first = prepare(cfg, 5, cache)
    inodes = [os.stat(os.path.join(first.root, p)).st_ino for p, _ in first.files]
    prepare(cfg, 6, cache)
    again = prepare(cfg, 2**31 + 9, cache)
    assert again.root == first.root
    assert [os.stat(os.path.join(again.root, p)).st_ino for p, _ in again.files] == inodes
    assert digest(again.root) == digest(prepare(cfg, 2**31 + 9, str(tmp_path / "fresh")).root)


def test_interrupted_plant_is_undone_and_changed_config_rebuilt(tmp_path):
    cfg = config("linux_src")
    cache = str(tmp_path / "kept")
    a = prepare(cfg, 3, cache)
    home = os.path.dirname(a.root)
    with open(os.path.join(home, "planted.json")) as f:
        saved = json.load(f)
    rel, pos, _ = saved[0]
    with open(os.path.join(a.root, rel), "r+b") as f:  # a run that died while planting
        f.seek(pos)
        f.write(b"#GARBAGE#")
    b = prepare(cfg, 4, cache)
    assert digest(b.root) == digest(prepare(cfg, 4, str(tmp_path / "fresh")).root)
    db = digest(b.root)
    os.remove(os.path.join(os.path.dirname(a.root), "complete"))  # a tree not known whole is written again
    assert digest(prepare(cfg, 4, cache).root) == db
    other = prepare(dict(cfg, text_seed=cfg["text_seed"] + 1), 4, cache)  # another configuration's text
    assert other.root != b.root and not os.path.exists(b.root)  # the old tree is gone
    assert digest(other.root) != db


def test_log_ioc_plants_cross_the_chunk_of_a_big_file():
    from scanbench.corpus import log_ioc

    big = reference.CHUNK + (64 << 10)
    cfg = dict(config("log_ioc"), big_log_bytes=[big])
    rel = [p for p, s in log_ioc.files(cfg) if s == big][0]
    for seed in (1, 2**31 + 3):
        mine = [(pos, t) for r, pos, t in log_ioc.plants(cfg, seed) if r == rel]
        (p0, t0), (p1, t1) = mine[:2]
        assert reference.CHUNK - reference.OVERLAP <= p0 and p0 + len(t0) <= reference.CHUNK  # in the overlap
        assert p1 < reference.CHUNK < p1 + len(t1)  # across the first chunk's end
        assert all(0 <= pos <= big - len(t) for pos, t in mine)


def test_linux_src_shape():
    from scanbench.corpus import linux_src

    cfg = dict(config("linux_src"), files=4000, total_bytes=40_000_000, dirs=400)
    files = linux_src.files(cfg)
    sizes = np.array([s for _, s in files])
    assert len(files) == 4000 and abs(sizes.sum() - 40_000_000) < 4000
    assert 3000 < np.median(sizes) < 12000  # log-normal, median near 6 KiB once scaled
    depth = [p.count("/") for p, _ in files]
    assert min(depth) >= 1 and max(depth) <= cfg["max_depth"]
    top = {}
    for p, s in files:
        top[p.split("/")[0]] = top.get(p.split("/")[0], 0) + s
    assert max(top, key=top.get) == "drivers"
    vocab = linux_src.vocabulary(cfg)
    assert not set(cfg["held_out"]) & set(vocab)


def test_log_ioc_shape():
    from scanbench.corpus import log_ioc

    cfg = json.load(open(os.path.join(ROOT, "scanbench", "configs", "log_ioc.json")))
    files = log_ioc.shape(cfg)
    logs = [s for _, s, binary in files if not binary]
    assert len(logs) == cfg["log_files"] + len(cfg["big_log_bytes"])
    assert abs(sum(logs) - cfg["log_total_bytes"] - sum(cfg["big_log_bytes"])) < 16
    assert max(logs) > reference.CHUNK  # grab's chunk and its overlap are crossed
    assert [s for _, s, binary in files if binary] == cfg["binary_bytes"]
    assert len({p for p, _, _ in files}) == len(files)


def test_held_out_identifiers_never_written(tmp_path):
    cfg = config("linux_src")
    corpus = prepare(cfg, 99, str(tmp_path))
    data = b"".join(open(p, "rb").read() for p, _ in reference.walk(corpus.root))
    for ident in cfg["held_out"]:
        assert ident.encode() not in data
    assert data.count(b"zQx##missing##") >= 3


@pytest.mark.parametrize("name,cfgname", [("miss", "linux_src"), ("requests", "linux_src"),
                                          ("hunt", "log_ioc")])
def test_sequence_same_multiset_for_every_seed(tmp_path, name, cfgname):
    cfg = config(cfgname)
    corpus = prepare(cfg, 1, str(tmp_path))
    m = mixmod.load(name)
    a = mixmod.sequence(m, corpus, 11)
    b = mixmod.sequence(m, corpus, 2**31 + 5)
    assert sorted(r.argv for r in a) == sorted(r.argv for r in b)
    assert a == mixmod.sequence(m, corpus, 11)
    if len(set(r.argv for r in a)) > 1:
        assert [r.argv for r in a] != [r.argv for r in b]
    for r in a[:50]:
        assert r.nbytes == sum(s for p, s in reference.walk(r.target))
    w = mixmod.warmups(m, corpus, a)
    for k in m.get("warmup_vary", []):
        assert {dict(r.values)[k] for r in w} == set(m["fields"][k]["pool"])


def test_requests_pool_identifiers_from_the_vocabulary():
    from scanbench.corpus import linux_src

    cfg = config("linux_src")
    vocab = set(linux_src.vocabulary(cfg))
    pool = mixmod.load("requests")["fields"]["pattern"]["pool"]
    idents = [p for p in pool if p.replace("_", "").isalnum()]
    assert len(idents) == 10
    assert sum(p in vocab for p in idents) == 7
    assert set(idents) - vocab == set(cfg["held_out"])
