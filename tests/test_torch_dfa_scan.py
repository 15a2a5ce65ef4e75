"""The port's last-resort DFA walk against the JAX package's.

``expand_byte_table``, the multi-stream walk's match-end bitmap, the
per-block counts and the DeviceScanner's "dfa" mode must equal the
reference's exactly (tolerance: exact — every output is an integer or a
bool). The JAX package computes this walk outside any Pallas kernel
(``lax.scan``), so both sides are plain tensor code here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grab_tpu.ops import dfa_scan as ref
from grab_tpu.regex.compiler import compile_multi as ref_compile
from grab_tpu_torch.ops import dfa_scan as port
from grab_tpu_torch.regex.compiler import compile_multi

NO_PLAN = rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"  # 1001 states, no stride plan
PATTERNS = [rb"needle", rb"[0-9]{3}-[0-9]{4}", rb".{0,2}[a-z ]{11,}", rb"a[0-9]*b",
            rb"\xff[\x80-\x9f]+\x00"]


def _data(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ab0123456789-needl xyz\n\xff\x85\x00", np.uint8)
    buf = rng.choice(alpha, size=n)
    for pos, s in ((100, b"needle"), (n // 4 - 3, b"555-1234"), (n // 2 - 2, b"needle"),
                   (n - 6, b"needle"), (3 * n // 4 - 1, b"a12345b"),
                   (n // 8 - 4, b"hello world and more"), (2000, b"555-1234"),
                   (2100, b"\xff\x85\x85\x00"), (2200, b"a77b")):
        buf[pos : pos + len(s)] = np.frombuffer(s, np.uint8)
    return buf


@pytest.mark.parametrize("pattern", PATTERNS + [NO_PLAN], ids=lambda p: p.decode("latin-1")[:24])
def test_expand_byte_table_identical(pattern):
    r, p = ref_compile([pattern]).dfa, compile_multi([pattern]).dfa
    want = ref.expand_byte_table(r.table, r.class_map)
    got = port.expand_byte_table(p.table, p.class_map)
    assert got.dtype == want.dtype and got.shape == want.shape == (r.n_states, 256)
    assert np.array_equal(got, want) and got.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("n_streams,halo", [(8, 64), (4, 0), (1, 4096), (16, 4096), (32, 7)])
@pytest.mark.parametrize("pattern", PATTERNS, ids=lambda p: p.decode("latin-1")[:24])
def test_bitmap_matches_reference(pattern, n_streams, halo):
    dfa = ref_compile([pattern]).dfa
    n = 4096
    data = _data(len(pattern) + n_streams, n)
    table = ref.expand_byte_table(dfa.table, dfa.class_map)
    want = np.asarray(ref.dfa_scan_bitmap(
        jnp.asarray(table), jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start),
        jnp.asarray(data), n_streams=n_streams, halo=halo))
    got = port.dfa_scan_bitmap(
        torch.from_numpy(table.astype(np.int32)), torch.from_numpy(np.asarray(dfa.accept_mask)),
        int(dfa.start), torch.from_numpy(data), n_streams=n_streams, halo=halo)
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), want) and want.any()
    for block in (512, 64):
        c_want = np.asarray(ref.bitmap_block_counts(jnp.asarray(want), block))
        c_got = port.bitmap_block_counts(got, block)
        assert c_got.dtype == torch.int32 and np.array_equal(c_got.numpy(), c_want)


def test_bitmap_rejects_ragged_streams():
    with pytest.raises(ValueError):
        port.dfa_scan_bitmap(torch.zeros((2, 256), dtype=torch.int32),
                             torch.zeros(2, dtype=torch.bool), 0,
                             torch.zeros(1000, dtype=torch.uint8), n_streams=7)


# -- DeviceScanner, dfa mode ------------------------------------------------

DFA_ROUTES = [
    (NO_PLAN, 64 << 10, 4096),  # no stride plan
    (rb".{0,2}[a-z ]{11,}", 64 << 10, 2048),  # a stride plan, buffer under 1 MiB
    (rb".{0,2}[a-z ]{11}", 128 << 10, 4096),
]


@pytest.mark.parametrize("pattern,buf_size,stream_seg", DFA_ROUTES,
                         ids=[p.decode()[:20] for p, _, _ in DFA_ROUTES])
def test_dfa_flags_match_reference(pattern, buf_size, stream_seg):
    """One packer buffer with planted matches: the port's scan == the
    reference DeviceScanner's (its jnp walk), same mode."""
    from grab_tpu.scan_pipeline import DeviceScanner as RefScanner
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    r = RefScanner(ref_compile([pattern]), buf_size=buf_size, stream_seg=stream_seg,
                   pallas_interpret=True)
    p = DeviceScanner(compile_multi([pattern]), buf_size=buf_size, stream_seg=stream_seg,
                      device="cpu")
    assert r.mode == p.mode == "dfa"
    member = p.members[0]
    assert type(member).__name__ == "DfaWalkMember"
    assert member.n_streams == r.n_streams == buf_size // stream_seg
    rng = np.random.default_rng(8)
    buf = rng.integers(48, 58, size=buf_size + 32 * 512, dtype=np.uint8)
    buf[buf_size:] = 0
    hit = (b"a1g" + b"AN") + b"".join(b"b2hBO" for _ in range(199))
    for pos in (777, buf_size // 2 - 500, buf_size - 1000 - 7):
        buf[pos : pos + len(hit)] = np.frombuffer(hit, np.uint8)
        buf[pos + 1100 : pos + 1114] = np.frombuffer(b"hello world ab", np.uint8)
    want = r.scan(buf)
    got = p.scan(buf)
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.sum() > 0
    clean = np.full(buf_size, ord("-"), np.uint8)
    assert p.scan(clean).sum() == r.scan(clean).sum() == 0
