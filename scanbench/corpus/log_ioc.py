"""A log archive swept for indicators: syslog and access-log text in a
couple of dozen large files and files past grab's 1 GiB chunk, beside a
few files of random bytes.

Shape (from the configuration's ``shape_seed``): ``log_files`` sizes
log-uniform in [``log_min_bytes``, ``log_max_bytes``] scaled to
``log_total_bytes``, the ``big_log_bytes`` files and the
``binary_bytes`` files. Bytes (from its ``text_seed``): log lines
(timestamps, IPv4 addresses, host names, URL paths, hex request ids)
from a seeded pool, and random bytes. Plants (from the run's seed): in
every log file a few indicators (the literals of ``plant_patterns``) at
seeded places.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from scanbench.corpus.textgen import CHUNK, CHUNK_PLACES, PLACES, plant_position, pool_arrays, text_from_pool

MONTHS = "Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov Dec".split()
PROCS = ("sshd", "nginx", "cron", "kernel", "systemd", "postfix/smtpd", "dockerd", "haproxy", "named")
EVENTS = (
    "session opened for user {user}",
    "Accepted publickey for {user} from {ip} port {port} ssh2",
    "Connection closed by {ip} port {port}",
    "connect from {host}.example.net[{ip}]",
    "Started {svc}.service.",
    "pam_unix({svc}:session): session closed for user {user}",
    "backend {svc}/{host} is UP, reason: Layer7 check passed, check duration: {small}ms",
    "client {ip}#{port}: query: {host}.example.net IN A + ({ip})",
)
PATHS = (
    "/api/v1/items/{n}", "/static/js/app.{hex8}.js", "/login", "/index.html", "/api/v2/users/{n}/orders",
    "/healthz", "/images/logo.png", "/search", "/cart/{n}", "/assets/css/site.{hex8}.css",
)
AGENTS = ("Mozilla/5.0 (X11; Linux x86_64)", "curl/8.5.0", "Go-http-client/1.1", "python-requests/2.31")
SERVICES = ("access", "error", "syslog", "auth", "mail", "daemon", "proxy", "dns")


def line_pool(cfg, seed: int) -> List[bytes]:
    r = random.Random(seed)
    hosts = cfg["hosts"]
    users = [f"u{i}" for i in range(300)]
    lines = []
    for _ in range(int(cfg["pool_lines"])):
        ip = "10.%d.%d.%d" % (r.randrange(256), r.randrange(256), r.randrange(256))
        mon, day = r.choice(MONTHS), r.randrange(1, 29)
        hh, mm, ss = r.randrange(24), r.randrange(60), r.randrange(60)
        if r.random() < 0.5:
            ev = r.choice(EVENTS).format(
                user=r.choice(users), ip=ip, port=r.randrange(1024, 65536), host=r.choice(hosts),
                svc=r.choice(SERVICES), small=r.randrange(1, 500))
            lines.append("%s %2d %02d:%02d:%02d %s %s[%d]: %s\n" % (
                mon, day, hh, mm, ss, r.choice(hosts), r.choice(PROCS), r.randrange(100, 65536), ev))
        else:
            path = r.choice(PATHS).format(n=r.randrange(100000), hex8="%08x" % r.getrandbits(32))
            lines.append('%s - - [%02d/%s/2026:%02d:%02d:%02d +0000] "%s %s?rid=%016x HTTP/1.1" %d %d "-" "%s"\n' % (
                ip, day, mon, hh, mm, ss, r.choice(("GET", "GET", "GET", "POST", "HEAD")), path,
                r.getrandbits(64), r.choice((200, 200, 200, 301, 304, 404, 500)), r.randrange(100, 90000),
                r.choice(AGENTS)))
    return [x.encode() for x in lines]


def shape(cfg) -> List[Tuple[str, int, bool]]:
    """(relative path, size, is_binary) of every file."""
    rng = np.random.default_rng(cfg["shape_seed"])
    n = int(cfg["log_files"])
    sizes = np.exp(rng.uniform(np.log(cfg["log_min_bytes"]), np.log(cfg["log_max_bytes"]), size=n))
    sizes = np.round(sizes * (cfg["log_total_bytes"] / sizes.sum())).astype(np.int64)
    hosts = cfg["hosts"]
    out = []
    for i, s in enumerate(sizes.tolist()):
        out.append((f"{hosts[i % len(hosts)]}/{SERVICES[i % len(SERVICES)]}.log.{i // len(hosts)}", int(s), False))
    for i, s in enumerate(cfg["big_log_bytes"]):
        out.append((f"{hosts[i % len(hosts)]}/all.log.{i}", int(s), False))
    for i, s in enumerate(cfg["binary_bytes"]):
        out.append((f"{hosts[(i * 3) % len(hosts)]}/core.{4100 + i}", int(s), True))
    return out


def files(cfg) -> List[Tuple[str, int]]:
    return [(p, s) for p, s, _ in shape(cfg)]


def write_base(cfg, root: str) -> None:
    """A log file: pieces of one seeded text, each from an offset of its
    own; a binary file: random bytes. Written a piece at a time."""
    seed = int(cfg["text_seed"])
    rng = np.random.default_rng([seed, 3])
    base = text_from_pool(rng, pool_arrays(line_pool(cfg, seed)), int(cfg["base_bytes"]))
    piece = int(cfg["piece_bytes"])
    for rel, size, binary in shape(cfg):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            for p in range(0, size, piece):
                n = min(piece, size - p)
                if binary:
                    f.write(rng.bytes(n))
                else:
                    o = int(rng.integers(0, base.size - n + 1))
                    f.write(memoryview(base[o : o + n]))


def plants(cfg, seed: int) -> List[Tuple[str, int, bytes]]:
    """In every log file ``plants_per_file`` of the indicators (the first
    ``plant_literals`` lines of ``plant_patterns``), at places drawn from
    ``seed``; in a file over one of grab's chunks the first two sit in
    the overlap at the first chunk's end and across that end."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, cfg["plant_patterns"]), "rb") as f:
        lits = [ln for ln in f.read().splitlines() if ln][: int(cfg["plant_literals"])]
    rng = np.random.default_rng([seed, 3])
    lo, hi = cfg["plants_per_file"]
    out = []
    for rel, size, binary in shape(cfg):
        if binary:
            continue
        first = CHUNK_PLACES if size > CHUNK else ()
        for j in range(int(rng.integers(lo, hi + 1))):
            t = lits[int(rng.integers(0, len(lits)))]
            place = first[j] if j < len(first) else PLACES[j % len(PLACES)]
            out.append((rel, plant_position(rng, size, len(t), place), t))
    return out
