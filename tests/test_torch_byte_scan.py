"""The port's byte-level scans against the JAX package's jnp functions.

``literal_scan_bitmap``, ``class_prefilter_bitmap`` and
``make_sharded_scan`` run in plain PyTorch on the CPU; the reference's
jit-compiled jnp versions run on CPU JAX (the sharded step over a mesh
of the conftest's virtual CPU devices). Data comes from numpy seeds:
random text, planted hits, and hits cut off by the buffer's end.
Tolerance: 0 — booleans and integer counts, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grab_tpu.ops import class_prefilter as ref_cp
from grab_tpu.ops import dfa_scan as ref_dfa
from grab_tpu.ops import literal_scan as ref_ls
from grab_tpu.parallel.scan_step import make_mesh, make_sharded_scan as ref_sharded
from grab_tpu.regex import ast as ref_ast
from grab_tpu.regex.compiler import compile_pattern as ref_compile
from grab_tpu.regex.parser import parse as ref_parse
from grab_tpu.scan_pipeline import HALO
from grab_tpu_torch.ops import class_prefilter as port_cp
from grab_tpu_torch.ops import literal_scan as port_ls
from grab_tpu_torch.parallel.scan_step import make_sharded_scan as port_sharded
from grab_tpu_torch.regex import ast as port_ast
from grab_tpu_torch.regex.compiler import compile_pattern as port_compile
from grab_tpu_torch.regex.parser import parse as port_parse


def buffer(kind, n, seed, needles=()):
    """uint8 [n]: random printable text with newlines, random binary, or
    zeros; ``needles`` planted at (pos, bytes), cut off at the end."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        data = rng.integers(32, 127, size=n, dtype=np.uint8)
        data[rng.random(n) < 0.02] = 0x0A
    elif kind == "binary":
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
    else:
        data = np.zeros(n, dtype=np.uint8)
    for pos, s in needles:
        s = np.frombuffer(s, dtype=np.uint8)[: n - pos]
        data[pos : pos + len(s)] = s
    return data


LITERAL_SETS = [
    [b"needle"],
    [b"needleXYZlonger", b"ab", b"q"],  # capped at 8 bytes; 1- and 2-byte literals
    [b"ab\x00", b"\x00\x00", b"Zz9"],  # zero bytes: the zero tail can complete them
]


def planted(lits, n):
    """Every literal at the start, in the middle and cut off by the end
    of the buffer (its first byte in the last byte)."""
    out = []
    for i, lit in enumerate(lits):
        out += [(3 * i, lit), (n // 2 + 17 * i, lit), (n - 1 - i, lit), (n - len(lit) + 1, lit)]
    return out


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("lits", LITERAL_SETS, ids=["one", "capped", "zero-bytes"])
def test_literal_scan_bitmap_equal(kind, lits):
    n = 8191  # not a multiple of any word or block
    data = buffer(kind, n, 31, planted(lits, n))
    mat, lens = port_ls.literal_matrix(lits)
    ref_mat, ref_lens = ref_ls.literal_matrix(lits)
    assert (mat == ref_mat).all() and (lens == ref_lens).all()
    got = port_ls.literal_scan_bitmap(mat, tuple(int(x) for x in lens), torch.from_numpy(data))
    want = np.asarray(ref_ls.np_literal_scan_bitmap(lits, data))
    assert got.dtype == torch.bool and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    if kind != "zeros":
        assert got.any()


CLASS_PATTERNS = [rb"\d+\.\d+", rb"[a-f]+xyz", rb"n[a-f]+le", rb"\w+@\w+", rb"[^\n]x[\x80-\xff]",
                  rb"(?s).a", rb"[aceg-ik-mo-qs-uw-y]{3}"]  # (?s). is 0..255; 9+ ranges


@pytest.mark.parametrize("kind", ["text", "binary", "zeros"])
@pytest.mark.parametrize("pattern", CLASS_PATTERNS, ids=repr)
def test_class_prefilter_bitmap_equal(kind, pattern):
    ref_seqs = ref_ast.prefix_class_sequences(ref_parse(pattern), 8)
    seqs = port_ast.prefix_class_sequences(port_parse(pattern), 8)
    assert seqs == ref_seqs and seqs
    compiled = port_cp.compile_sequences(seqs)
    assert compiled == ref_cp.compile_sequences(ref_seqs)
    n = 6000
    data = buffer(kind, n, 41, [(100, b"3.14 abcxyz x@y"), (n - 3, b"9.5"), (n - 2, b"bxyz"),
                                (2000, b"\x01x\x90 nacle")])
    got = port_cp.class_prefilter_bitmap(compiled, torch.from_numpy(data))
    want = np.asarray(ref_cp.np_class_prefilter_bitmap(ref_seqs, data))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_membership_full_range_is_true():
    plane = torch.tensor([0, 7, 255], dtype=torch.int32)
    assert port_cp._membership(plane, ((5, 9), (0, 255))).all()
    assert port_cp._membership(plane, ((7, 7),)).tolist() == [False, True, False]


SHARD = 64 << 10  # 2 DFA streams of 32 KiB per shard


def sharded_data(n_shards, seed, needle):
    n = n_shards * SHARD
    needles = [(d * SHARD + 100 + d, needle) for d in range(n_shards)]
    needles += [(d * SHARD - 3, needle) for d in range(1, n_shards)]  # across shards
    needles += [(n - 4, needle), (SHARD // 2 - 2, needle)]  # the end; across streams
    return buffer("text", n, seed, needles)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("pattern,needle", [(rb"fooxyzzbar", b"fooxyzzbar"),
                                            (rb"[a-f]{3}[0-9]{4}", b"abc1234")],
                         ids=["literal", "dfa"])
def test_make_sharded_scan_equal(n_shards, pattern, needle):
    """One shard against the reference's one-device mesh, N shards on N
    CPU devices against the reference's per-shard results and psum. The
    reference's DFA step does not trace under this JAX's shard_map (its
    scan carry lacks the varying-axis cast), so for a pattern without a
    literal the reference side is its per-shard body: the jnp walk with
    the HALO overlap and its block counts, shard by shard."""
    cp, ref_cp_ = port_compile(pattern), ref_compile(pattern)
    assert cp.literals == ref_cp_.literals and bool(cp.literals) == (needle == pattern)
    data = sharded_data(n_shards, 51, needle)
    n_streams = max(1, SHARD // 32768)
    if cp.literals:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = make_mesh(n_shards)
        ref_counts, ref_total = ref_sharded(ref_cp_, mesh, SHARD)(
            jax.device_put(jnp.asarray(data), NamedSharding(mesh, P("shards"))))
    else:
        dfa = ref_cp_.dfa
        table = jnp.asarray(ref_dfa.expand_byte_table(dfa.table, dfa.class_map))
        per = [ref_dfa.bitmap_block_counts(
            ref_dfa.dfa_scan_bitmap(table, jnp.asarray(dfa.accept_mask), jnp.int32(dfa.start),
                                    jnp.asarray(data[d * SHARD : (d + 1) * SHARD]),
                                    n_streams=n_streams, halo=HALO), 512)
            for d in range(n_shards)]
        ref_counts = jnp.concatenate(per)
        ref_total = sum(int(c.sum()) for c in per)
    ref_counts = np.asarray(ref_counts)
    fn = port_sharded(cp, ["cpu"] * n_shards, SHARD)
    counts, total = fn(torch.from_numpy(data))
    assert len(counts) == n_shards and all(c.dtype == torch.int32 for c in counts)
    got = torch.cat(counts).numpy()
    assert np.array_equal(got, ref_counts)
    assert total.dtype == torch.int32 and int(total) == int(ref_total) >= n_shards
    with pytest.raises(ValueError):
        fn(torch.from_numpy(data[:-1]))


# -- the literal kernel's keys and window compare (csrc/literal_scan.cu) ----


def literal_kernel_model(data: np.ndarray, mask: np.ndarray, value: np.ndarray,
                         block: int = 512) -> np.ndarray:
    """A numpy model of the kernel: per 512 bytes, lane l holds bytes
    [16l, 16l + 16) as four little-endian words and takes the next 8 from
    lane l + 1 (lane 31 from the next 512 bytes, or zero past the end);
    the window at byte i of the lane is the funnel shift of those words;
    a position hits when some key's (window & mask) == value; its hits
    are counted per block. → int32 [N / block]."""
    n = data.size
    words = data.view("<u4").reshape(-1, 32, 4).astype(np.uint64)  # [chunks, lanes, 4]
    nxt = np.zeros(words.shape[:2] + (2,), np.uint64)
    nxt[:, :31] = words[:, 1:, :2]
    nxt[:-1, 31] = words[1:, 0, :2]  # the last chunk's lane 31: the zero tail
    w = np.concatenate([words, nxt], axis=2)  # [chunks, lanes, 6]
    hits = np.zeros(words.shape[:2] + (16,), bool)
    low32 = np.uint64(0xFFFFFFFF)

    def funnel(a, b, r):  # __funnelshift_r(a, b, 8r): the low word of (b:a) >> 8r
        return ((a | b << np.uint64(32)) >> np.uint64(8 * r)) & low32

    for i in range(16):
        q, r = divmod(i, 4)
        lo, hi = funnel(w[..., q], w[..., q + 1], r), funnel(w[..., q + 1], w[..., q + 2], r)
        win = hi << np.uint64(32) | lo
        hits[..., i] = ((win[..., None] & mask) == value).any(axis=-1)
    return hits.reshape(n // block, -1).sum(axis=1).astype(np.int32)


W2_SETS = {  # 1-, 3-, 8- and 11-byte literals, a zero-length and NUL-ending ones
    "K1": [b"fooxyzzbar"],
    "K16": [b"q", b"fox", b"abcdefgh", b"needle-in-a", b"", b"ab\x00", b"xyz\x00\x00",
            b"\x00\x00\x00"] + [b"lit%02d-xy" % i for i in range(8)],
    "K300": [bytes(np.random.default_rng(i).integers(33, 127, size=1 + i % 11, dtype=np.uint8))
             for i in range(300)],
}


def w2_data(lits, n, seed):
    """Text with sparse NULs, every literal planted across block edges
    and at random, and the buffer's last bytes the head of a NUL-ending
    literal (or a whole literal): a hit in the shard's last 7 bytes."""
    rng = np.random.default_rng(seed)
    data = buffer("text", n, seed)
    data[rng.integers(0, n, size=n // 500)] = 0
    for i, lit in enumerate(lits * max(1, 64 // len(lits))):
        pos = 512 * (i % (n // 512)) + 509 if i % 2 else int(rng.integers(0, n - 16))
        data[pos : pos + len(lit)] = np.frombuffer(lit, np.uint8)[: n - pos]
    nul_end = [l for l in lits if l.endswith(b"\x00") and l.strip(b"\x00")]
    tail = nul_end[0].rstrip(b"\x00") if nul_end else min(lits, key=len)
    data[n - len(tail) :] = np.frombuffer(tail, np.uint8)
    return data


@pytest.mark.parametrize("case", sorted(W2_SETS))
def test_literal_kernel_model_equals_reference(case):
    """The host's (mask, value) keys and the model of the kernel's window
    compare give the reference literal_scan_bitmap's block counts."""
    lits = W2_SETS[case]
    n = 16 << 10
    data = w2_data(lits, n, len(lits))
    keys = port_ls.LiteralKeys(lits)
    assert keys.mask.dtype == keys.value.dtype == np.uint64 and keys.mask.shape == (len(lits),)
    want = np.asarray(ref_dfa.bitmap_block_counts(
        jnp.asarray(ref_ls.np_literal_scan_bitmap(lits, data)), 512))
    got = literal_kernel_model(data, keys.mask, keys.value)
    assert np.array_equal(got, want) and want[-1] > 0
    if case == "K16":  # the zero-length literal hits every NUL byte
        assert want.sum() >= int((data == 0).sum())


def test_literal_keys_cover_max_length_one():
    """mask = max(L, 1) bytes; value = the literal's capped bytes."""
    mask, value = port_ls.literal_keys(*port_ls.literal_matrix(
        [b"", b"a", b"ab\x00", b"abcdefgh", b"abcdefghijk"]))
    assert mask.tolist() == [0xFF, 0xFF, 0xFFFFFF, 2**64 - 1, 2**64 - 1]
    assert value.tolist() == [0, 0x61, 0x6261, 0x6867666564636261, 0x6867666564636261]
    with pytest.raises(ValueError):
        port_ls.LiteralKeys([])


@pytest.mark.parametrize("case", sorted(W2_SETS))
def test_literal_block_counts_cpu_equals_reference_body(case):
    """literal_block_counts on a CPU tensor == the reference's per-shard
    body (literal_scan_bitmap, then bitmap_block_counts), and counts no
    kernel launch."""
    lits = W2_SETS[case]
    n = 8 << 10
    data = w2_data(lits, n, 3 + len(lits))
    mat, lens = ref_ls.literal_matrix(lits)
    want = np.asarray(ref_dfa.bitmap_block_counts(ref_ls.literal_scan_bitmap(
        jnp.asarray(mat), tuple(int(x) for x in lens), jnp.asarray(data)), 512))
    before = port_ls.literal_block_counts.launches
    got = port_ls.literal_block_counts(torch.from_numpy(data), port_ls.LiteralKeys(lits), 512)
    assert port_ls.literal_block_counts.launches == before
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        port_ls.literal_block_counts(torch.from_numpy(data[:-1]), port_ls.LiteralKeys(lits), 512)
