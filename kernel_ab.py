#!/usr/bin/env python3
"""Times kernels of the grab_tpu_torch port on one CUDA card, in the
checkout it runs from: the strided-DFA walk (B2), the fused ensemble
(B6), the alphabet runs (B3), the class sequences (B4), the XOR filter
(B5), the last-resort DFA walk (W1) and the literal byte step (W2).

    python3 kernel_ab.py [stride|fused|both|alpha|seq|xor|walk|fixpoint|literal|sass]

Run it from the root of two checkouts in turns (A, B, B, A) on one
card, one after the other, to compare two versions of the kernels: both
trees' chip_smoke.py give it the same seeded inputs. It prints one JSON
line, RESULT {...}: device ms per 32 MiB buffer (CUDA events after a
sleep kernel, over 4 distinct buffers, the better of two runs of 40
launches), for every plan family of chip_smoke.STRIDE_PLANS on text
with start entries, the non-synchronising automaton over one Q per
stream, the scanner's fixpoint and window passes (these include the
gaps between their queued launches), and the fused ensembles of
chip_smoke.phase_fused plus single-member ensembles (the filter, the
sequences, one bucket) that split the fused time into its members;
``alpha`` every plan of chip_smoke.ALPHA_CASES and ``seq`` every set of
chip_smoke.seq_sets on their text buffers, each beside the profiler's
device ms per launch by name (the kernel body, and the memsets and
copies queued on the stream around it); ``xor`` every literal count of
chip_smoke.phase_xor the same way and, in a checkout whose wrapper
chooses how many copies of the bank rows a block keeps
(ops/xorfilter.py bank_copies), each other form that fits, forced, on
those sets and on 150, 250 and 500 literals (7, 11 and 22 bank rows);
``walk`` the script's own WALK_AB_CASES (32 MiB: NO_PLAN, a table in
global memory, an automaton that never synchronises) through
``DfaWalkMember.packed`` (the kernel, or the plain loop in a checkout
without one), the median of 5 runs of 4 launches, and in a checkout
with the segmented walk the bytes its fix-up re-walked; ``fixpoint``
B2's threading fixpoint (``StrideDfaScanner.run_t``) of
``.{0,2}(?:[0-9a-zA-Z]{4})+`` and ``a[0-9]*b`` on 32 MiB buffers born
transposed (chip_smoke.phase_stride_scanner's, 4 distinct copies), the
better of two runs of 20 calls, beside the profiler's device ms per
call by kernel name, the walks run and the launches a call makes;
``literal`` W2 (``literal_block_counts``) at chip_smoke.py's
w2_literal_sets (K1, K16, K300, K1000, dense: the sets and buffers of
the chip_smoke.py beside this script, so both checkouts get the same
inputs) over 4 distinct 32 MiB buffers a case, the better of two runs
of 40 launches, in the form the host chooses and, in a checkout whose
wrapper takes form=, in each form forced, then both forms at 1-5
literals of 3-11 bytes on text (the SWAR form's side of the
crossover that sets SWAR_MAX); ``sass`` builds the checkout's
csrc/literal_scan.cu with ``nvcc -cubin -Xptxas -v`` (registers,
spills) and counts each kernel's SASS instructions with ``cuobjdump
-sass``: in all, and per loop (a backward branch), each loop's own
(nested loops left out) by opcode.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402  (the checkout's own, for its inputs)


def stride_times(rng, dev):
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    s_w = cs.BUF // sd.N_STREAMS // 4
    alpha = np.frombuffer(cs.STRIDE_ALPHABET, np.uint8)
    text = rng.choice(alpha, size=cs.BUF).view("<i4").reshape(s_w * 128, 128)
    ring = [torch.from_numpy(text).to(dev) for _ in range(4)]
    qraw = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8), size=(16384, 4 * s_w))
    qraw[:, 0] = ord("Q")
    qw = np.ascontiguousarray(qraw.reshape(-1).view("<i4").reshape(16384, s_w).T)
    qring = [torch.from_numpy(qw.reshape(s_w * 128, 128)).to(dev) for _ in range(4)]
    res = {}
    for pat, _plan in cs.STRIDE_PLANS + [(rb"Q(?:[a-z]{2})*Q", ("run", 2))]:
        dfa = compile_multi([pat]).dfa
        t = sd.StrideDfaTables(dfa, sd.stride_plan(dfa))
        e = torch.full((128, 128), t.start, dtype=torch.int32, device=dev)
        r = qring if pat.startswith(b"Q") else ring
        res[pat.decode("latin-1")] = min(
            cs.time_cuda(torch, lambda i: sd.stride_dfa_scan(r[i % 4], t, e), 40) for _ in range(2))
    punct = cs.punct_bytes(np, rng, cs.BUF)
    for s in range(3, 16000, 211):
        cs.plant_run(punct, s * 2048 - 9, 30)
    digits = np.full(cs.BUF, ord(" "), dtype=np.uint8)
    for pos, span in ((9 * 2048 + 100, 7000), (4000 * 2048 - 30, 50), (cs.BUF - 3000, 2990)):
        digits[pos] = ord("a")
        digits[pos + 1 : pos + span] = ord("7")
        digits[pos + span] = ord("b")
    text = rng.integers(33, 127, size=cs.BUF, dtype=np.uint8)
    for label, pat, buf in (("fixpoint -E", rb".{0,2}(?:[0-9a-zA-Z]{4})+", punct),
                            ("fixpoint a[0-9]*b", rb"a[0-9]*b", digits),
                            ("window .{0,2}[a-z ]{11}", rb".{0,2}[a-z ]{11}", text)):
        cp = compile_multi([pat])
        sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, cs.BUF)
        wd = torch.from_numpy(sc.prep_t(buf)).to(dev)
        res[label] = min(cs.time_cuda(torch, lambda i: sc.run_t(wd), 10) for _ in range(2))
    return res


def fused_times(rng, dev):
    from grab_tpu_torch.ops import fused as fu
    from grab_tpu_torch.ops.classseq import compile_sequences
    from grab_tpu_torch.regex.compiler import compile_multi
    from grab_tpu_torch.scan_pipeline import DeviceScanner

    lower = sum(1 << b for b in range(97, 123))
    one = compile_sequences([(cs.DIGIT, cs.DIGIT, cs.DIGIT, lower, lower)])
    three = compile_sequences([(cs.DIGIT,) * 5, (cs.HIGH, cs.DIGIT, cs.HIGH), (cs.DIGIT,) * 8])
    longs = cs.long_literals(np, rng, 100)
    shorts = [bytes(rng.integers(97, 123, size=int(rng.integers(3, 7)), dtype=np.uint8))
              for _ in range(60)]
    # the default device: the members are the same on every device
    batch4 = DeviceScanner(compile_multi(cs.batch_literals(np) + cs.BATCH_REGEXES),
                           buf_size=1 << 20).members[0]
    sets = {
        "100 long + 1 seq": fu.FusedEnsembleScanner(longs, one),
        "60 short + 40 long + 3 seqs": fu.FusedEnsembleScanner(shorts + longs[:40], three),
        "1 bucket + 3 seqs": fu.FusedEnsembleScanner([b"linus", b"lmnus", b"lnnus"], three),
        "batch4": batch4,
        "xor 100 only": fu.FusedEnsembleScanner(longs, None),
        "1 seq only": fu.FusedEnsembleScanner([], one),
        "3 seqs only": fu.FusedEnsembleScanner([], three),
        "bucket K4 W2 only": fu.FusedEnsembleScanner([b"linus", b"lmnus", b"lnnus"], None),
        "bucket K16 W2 only": fu.FusedEnsembleScanner(shorts[:16], None),
    }
    bufs = cs.kernel_buffers(np, rng, [b"linus", b"123ab", b"\x805\x81"] + longs[:5])
    ring = [torch.from_numpy(bufs["text"]).to(dev) for _ in range(4)]
    return {name: min(cs.time_cuda(torch, lambda i: fu.fused_word_flags(ring[i % 4], sc), 40)
                      for _ in range(2))
            for name, sc in sets.items()}


def own_smoke():
    """The chip_smoke.py beside this script (its profile_split), which
    the other checkout's may lack."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(fn, split):
    """{ms: events, the better of two runs of 40; by_name: profiler}."""
    ms = min(cs.time_cuda(torch, fn, 40) for _ in range(2))
    return {"ms": ms, "by_name": split(torch, fn)}


def alpha_times(rng, dev):
    from grab_tpu_torch.ops import alpharun as ar

    split = own_smoke().profile_split
    res = {}
    for name, ranges, plans in cs.ALPHA_CASES:
        text = torch.from_numpy(cs.run_buffers(np, rng, ranges)["text"]).to(dev)
        ring = [text] + [text.clone() for _ in range(3)]
        for mode, units in plans:
            res[f"{name} {mode} {units}"] = timed(
                lambda i: ar.alpharun_flags(ring[i % 4], ranges, mode, units), split)
    return res


def seq_times(rng, dev):
    from grab_tpu_torch.ops import classseq as cq

    split = own_smoke().profile_split
    res = {}
    for name, seqs in cs.seq_sets(np, rng).items():
        needles = [cs.seq_needle(s, rng) for s in seqs]
        text = torch.from_numpy(cs.kernel_buffers(np, rng, needles)["text"]).to(dev)
        ring = [text] + [text.clone() for _ in range(3)]
        res[name] = timed(lambda i: cq.classseq_flags(ring[i % 4], seqs), split)
    return res


def xor_times(rng, dev):
    from grab_tpu_torch.ops import xorfilter as xf

    smoke = own_smoke()
    split = smoke.profile_split
    choose = getattr(xf, "bank_copies", None)
    sets = [(k, rng) for k in smoke.XOR_SIZES]
    if choose is not None:
        sets += [(k, np.random.default_rng(k)) for k in (150, 250, 500)]
    res = {}
    for k, r in sets:
        lits = cs.long_literals(np, r, k)
        tests = xf.XorWordTests(lits)
        text = torch.from_numpy(cs.kernel_buffers(np, r, lits)["text"]).to(dev)
        ring = [text] + [text.clone() for _ in range(3)]
        if k in smoke.XOR_SIZES:
            res[f"{k} literals"] = timed(lambda i: xf.xor_word_flags(ring[i % 4], tests), split)
        if choose is None:
            continue
        n_groups, n_rows = len(tests.consts()), sum(len(c) for c in tests.consts())
        head = (n_groups + n_rows + 3) // 4 * 16
        try:
            for copies in (32, 16, 1, 0):
                if head + n_rows * 512 * copies > xf.SHARED_LIMIT:
                    continue
                xf.bank_copies = lambda g, n, c=copies: c
                res[f"{k} literals ({n_rows} rows), "
                    + (f"{copies} copies" if copies else "global memory")
                    + (" (chosen)" if copies == choose(n_groups, n_rows) else "")] = min(
                    cs.time_cuda(torch, lambda i: xf.xor_word_flags(ring[i % 4], tests), 40)
                    for _ in range(2))
        finally:
            xf.bank_copies = choose
    return res


WALK_NO_PLAN = rb".{0,2}(?:[a-f][0-9][g-m][A-F][N-Z]){200}"  # 1001 states, no stride plan
WALK_WIDE = b".{0,2}" + bytes(  # 1901 states x 64 classes: the table in global memory
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"[(i * 7) % 62]
    for i in range(1900))
WALK_AB_CASES = [  # (label, pattern, text), 32 MiB in 1,024 streams of 32 KiB
    ("NO_PLAN 32 MiB", WALK_NO_PLAN, "printable"),
    ("wide table 32 MiB", WALK_WIDE, "printable"),
    # the parity of the letters since a Q never synchronises: one Q near
    # each stream's start makes every later guess of the stream wrong
    ("Q(?:[a-z]{2})*Q 32 MiB, one Q a stream", rb"Q(?:[a-z]{2})*Q", "lowercase + Q"),
]


def walk_times(rng, dev):
    """The last-resort walk through DfaWalkMember.packed on WALK_AB_CASES
    (median of 5 runs of 4 launches); in a checkout with the segmented
    walk (ops/dfa_scan.py fixup_bytes), also the bytes its fix-up
    re-walked in one launch."""
    import statistics

    from grab_tpu_torch.ops import dfa_scan as ds
    from grab_tpu_torch.regex.compiler import compile_multi

    res = {}
    for label, pattern, text in WALK_AB_CASES:
        m = ds.DfaWalkMember(compile_multi([pattern]).dfa, cs.BUF, 512, 32768, 0x1000)
        if text == "printable":
            buf = rng.integers(32, 127, size=cs.BUF, dtype=np.uint8)
        else:
            buf = rng.integers(ord("a"), ord("z") + 1, size=cs.BUF, dtype=np.uint8)
            buf[7::32768] = ord("Q")
        ring = [torch.from_numpy(buf).to(dev) for _ in range(4)]
        res[label] = statistics.median(
            cs.time_cuda(torch, lambda i: m.packed(ring[i % 4]), 4, warmup=1) for _ in range(5))
        if hasattr(ds, "fixup_bytes"):
            ds.fixup_bytes(dev, reset=True)
            m.packed(ring[0])
            res[label + ", bytes re-walked"] = ds.fixup_bytes(dev, reset=True)
    return res


def fixpoint_times(rng, dev):
    """run_t of the two threading patterns; → {label: {ms, by_name,
    walks, launches per call by wrapper}}."""
    from grab_tpu_torch.ops import stridedfa as sd
    from grab_tpu_torch.regex.compiler import compile_multi

    split = own_smoke().profile_split
    punct = cs.punct_bytes(np, rng, cs.BUF)
    for s in range(3, 16000, 211):
        cs.plant_run(punct, s * 2048 - 9, 30)
    cs.plant_run(punct, 5 * 2048 + 100, 6000)
    digits = np.full(cs.BUF, ord(" "), dtype=np.uint8)
    for pos, span in ((9 * 2048 + 100, 7000), (4000 * 2048 - 30, 50), (cs.BUF - 3000, 2990)):
        digits[pos] = ord("a")
        digits[pos + 1 : pos + span] = ord("7")
        digits[pos + span] = ord("b")
    wrappers = [w for w in (sd.stride_dfa_scan, getattr(sd, "stride_dfa_fixpoint", None))
                if hasattr(w, "launches")]
    res = {}
    for label, pat, buf in (("-E .{0,2}(?:[0-9a-zA-Z]{4})+", rb".{0,2}(?:[0-9a-zA-Z]{4})+",
                             punct), ("a[0-9]*b", rb"a[0-9]*b", digits)):
        cp = compile_multi([pat])
        sc = sd.StrideDfaScanner(cp.dfa, cp.max_len, cs.BUF)
        w = torch.from_numpy(sc.prep_t(buf)).to(dev)
        ring = [w] + [w.clone() for _ in range(3)]
        before = [f.launches for f in wrappers]
        _bm, n, _conv = sc.run_t(ring[0])
        launched = {f.__name__: f.launches - b for f, b in zip(wrappers, before)}
        res[label] = {"ms": min(cs.time_cuda(torch, lambda i: sc.run_t(ring[i % 4]), 20)
                                for _ in range(2)),
                      "by_name": split(torch, lambda i: sc.run_t(ring[i % 4])),
                      "walks": int(n), "launches_per_call": launched}
    return res


def literal_times(rng, dev):
    """W2 per case (and per form where the wrapper takes form=); → {label: ms}."""
    import inspect

    from grab_tpu_torch.ops import literal_scan as ls

    smoke = own_smoke()
    forms = getattr(ls, "FORMS", ()) if "form" in inspect.signature(
        ls.literal_block_counts).parameters else ()
    res = {}

    def best(ring, keys, **kw):
        return min(cs.time_cuda(torch, lambda i: ls.literal_block_counts(
            ring[i % 4], keys, 512, **kw), 40) for _ in range(2))

    for label, lits in smoke.w2_literal_sets(np, rng).items():
        keys = ls.LiteralKeys(lits)
        ring = [torch.from_numpy(smoke.w2_buffer(np, rng, lits, dense=label == "dense")).to(dev)
                for _ in range(4)]
        res[label] = best(ring, keys)
        for form in forms:
            if form == "table" or len(lits) <= ls.SWAR_MAX:
                res[f"{label} {form}"] = best(ring, keys, form=form)
        del ring
    if forms:
        lits5 = [bytes(rng.integers(33, 127, size=int(rng.integers(3, 12)), dtype=np.uint8))
                 for _ in range(ls.SWAR_MAX)]
        ring = [torch.from_numpy(smoke.w2_buffer(np, rng, lits5)).to(dev) for _ in range(4)]
        for k in range(1, ls.SWAR_MAX + 1):
            keys = ls.LiteralKeys(lits5[:k])
            for form in forms:
                res[f"crossover K{k} {form}"] = best(ring, keys, form=form)
    return res


def sass_counts():
    """nvcc -Xptxas -v's lines and, per kernel, SASS instruction counts:
    in all and per loop (own instructions by opcode)."""
    import re
    import subprocess
    import tempfile

    from grab_tpu_torch import _build

    src = os.path.join(os.getcwd(), "grab_tpu_torch", "csrc", "literal_scan.cu")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "literal_scan.cubin")
        built = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", src, "-o",
                                cubin], capture_output=True, text=True, timeout=600)
        if built.returncode:
            raise RuntimeError(built.stderr)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                              check=True, timeout=300).stdout
    out = {"ptxas": [l.strip() for l in built.stderr.splitlines()
                     if "ptxas" in l or "spill" in l],
           "kernels": {}}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        addrs = [a for a, _ in ins]
        loops = sorted({(int(m.group(1), 16), a) for a, t in ins
                        for m in [re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)]
                        if m and int(m.group(1), 16) < a}, key=lambda l: l[1] - l[0])
        rows = []
        for i, (lo, hi) in enumerate(loops):
            inner = [l for l in loops[:i] if lo <= l[0] and l[1] <= hi]
            own = [t for a, t in ins if lo <= a <= hi
                   and not any(l[0] <= a <= l[1] for l in inner)]
            ops = {}
            for t in own:
                op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                ops[op] = ops.get(op, 0) + 1
            rows.append({"from": hex(lo), "to": hex(hi), "n": sum(lo <= a <= hi for a in addrs),
                         "own": len(own), "own_by_opcode": dict(sorted(ops.items()))})
        out["kernels"][name] = {"instructions": len(ins), "loops": rows}
    return out


def main() -> int:
    what = sys.argv[1] if len(sys.argv) > 1 else "both"
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out = {"tree": os.getcwd(), "card": cs.smi("name,power.limit")}
    if what in ("both", "stride"):
        out["stride_ms"] = stride_times(rng, dev)
    if what in ("both", "fused"):
        out["fused_ms"] = fused_times(rng, dev)
    if what == "alpha":
        out["alpha"] = alpha_times(rng, dev)
    if what == "seq":
        out["seq"] = seq_times(rng, dev)
    if what == "xor":
        out["xor"] = xor_times(rng, dev)
    if what == "walk":
        out["walk_ms"] = walk_times(rng, dev)
    if what == "fixpoint":
        out["fixpoint"] = fixpoint_times(rng, dev)
    if what == "literal":
        out["literal_ms"] = literal_times(rng, dev)
    if what == "sass":
        out["literal_sass"] = sass_counts()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
