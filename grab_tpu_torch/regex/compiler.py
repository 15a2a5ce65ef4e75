"""Top-level pattern compiler: pattern(s) → CompiledPattern.

The analog of FileGrep::prepare (greppin src/grab.cc:101-123),
which does pcre_compile + pcre_study(JIT) + PCRE_INFO_MINLENGTH. Here
"prepare" produces everything the TPU pipeline needs:

  * dense DFA transition table + byte classes (device candidate scan),
  * literal prefilter factors (device Teddy-style scan),
  * exact backtracking program (host verify/replay),
  * minlen (file-skip prune, grab.cc:133-135), maxlen (halo sizing),
  * semantics flags (captures → PCRE1 ovector quirk, anchors → verify
    required, backrefs → host-only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from grab_tpu_torch.regex import ast as A
from grab_tpu_torch.regex.backtrack import Matcher, PatternTooLarge, compile_program
from grab_tpu_torch.regex.dfa import DFA, DFABlowup, build_dfa
from grab_tpu_torch.regex.nfa import NotAutomatable
from grab_tpu_torch.regex.parser import parse


@dataclass
class CompiledPattern:
    patterns: List[bytes]  # source pattern(s)
    asts: List[A.Node]
    dfa: Optional[DFA]  # search DFA (match-end candidates); None if not automatable
    matchers: List[Matcher]  # exact engine per pattern
    min_len: int  # min over patterns (drives the file prune)
    min_lens: List[int]
    max_len: Optional[int]  # max over patterns; None if any unbounded
    literals: Optional[List[bytes]]  # prefilter factor alternatives (len >= 3)
    class_seqs: Optional[List[tuple]]  # class-mask prefilter sequences
    covered: bool  # literals ∪ class_seqs covers every pattern (device-sound)
    alpha_plan: Optional[tuple]  # ((lo, hi) byte ranges, run length):
    # mandatory class-run prefilter plan for factor-less patterns —
    # works even without a DFA (regex/alphabet.py + ops/pallas_alpharun)
    seq_dfa: Optional[DFA]  # union automaton over the patterns routed
    # to class_seqs (PLUS short literal factors when seqs exist — see
    # seq_includes_shorts): when stride-eligible, the ensemble serves
    # all of them with one k-byte-strided gather per word instead of
    # per-(seq, phase) range-test AND chains (ops/pallas_stridedfa)
    seq_max_len: Optional[int]  # max match length over seq-routed
    # patterns; None if any unbounded
    seq_dfa_shorts: Optional[DFA]  # union of seq_dfa's patterns PLUS
    # the < 7-byte literal factors (round 4): each short costs ~17
    # fused VPU ops/word in a compare bucket but is free inside the
    # member's automaton. Whether absorbing them is a win depends on
    # how the extra byte classes change the stride plan, so the scan
    # pipeline compares stride_plan(seq_dfa) vs
    # stride_plan(seq_dfa_shorts) and picks at build time.
    seq_shorts_max_len: Optional[int]
    has_captures: bool
    needs_verify: bool  # device candidates are a superset → host must verify
    literal_mode: bool  # compiled via -S (plain literals, no regex parse)

    @property
    def n_patterns(self) -> int:
        return len(self.patterns)


def _as_bytes(p) -> bytes:
    return p.encode("utf-8") if isinstance(p, str) else bytes(p)


def pattern_route(t: A.Node):
    """How ``compile_multi`` covers one pattern of a batch: ("literals",
    its mandatory literal alternatives), ("seqs", its class-mask
    sequences) or (None, None), where nothing covers it."""
    l = A.mandatory_literals(t)
    if l and min(len(x) for x in l) >= 3 and len(l) <= 64:
        return "literals", l
    s = A.prefix_class_sequences(t, 8)
    if s:
        return "seqs", s
    if l:
        # weak/tiny factors and no sequences: a literal IS a class
        # sequence of singleton classes — route it there so the
        # literal kernels only ever see len >= 3 alternatives
        return "seqs", [tuple(1 << b for b in x[:8]) for x in l]
    return None, None


def device_class_seqs(cp: "CompiledPattern") -> Optional[List[tuple]]:
    """The class sequences of a literal ensemble's device member: for
    each pattern ``compile_multi`` sent to sequences, its
    ``ast.device_class_sequences`` (carried past the first repeat),
    where the batch's set stays within 32 sequences and the rules give
    any; else the compiler's own for that pattern. None where the batch
    has no sequences."""
    if not cp.class_seqs:
        return None
    plans = [set(plan) if route == "seqs" else set()
             for route, plan in map(pattern_route, cp.asts)]
    for i, t in enumerate(cp.asts):
        if not plans[i]:
            continue
        longer = A.device_class_sequences(t, 8)
        if longer and len(set().union(*plans[:i], longer, *plans[i + 1 :])) <= 32:
            plans[i] = set(longer)
    return sorted(set().union(*plans))


def compile_multi(
    patterns,
    literal_mode: bool = False,
    state_cap: int = 8192,
) -> CompiledPattern:
    """Compile one or more patterns into a single scan unit.

    Multi-pattern batches compile into one union automaton with
    per-pattern accept ids — the hyperscan-batch capability of the
    greppin branch (greppin README.md:63-92).
    """
    pats = [_as_bytes(p) for p in patterns]
    if literal_mode:
        asts = [A.literal_string(p) for p in pats]
    else:
        asts = [parse(p) for p in pats]

    min_lens = [A.min_len(t) for t in asts]
    mn = min(min_lens)
    mx: Optional[int] = 0
    for t in asts:
        m = A.max_len(t)
        mx = None if (m is None or mx is None) else max(mx, m)

    dfa: Optional[DFA] = None
    try:
        dfa = build_dfa(asts, unanchored=True, state_cap=state_cap)
    except (NotAutomatable, DFABlowup):
        dfa = None

    matchers = [Matcher(compile_program(t)) for t in asts]

    # per-pattern prefilter plan (hyperscan-style decomposition): each
    # pattern is covered by EITHER its best mandatory literal
    # alternative-set (every match contains >= 1 member) or its prefix
    # class sequences; the device ensemble unions both kinds. A batch
    # is ``covered`` iff every pattern got a plan — only then can the
    # device prefilter be trusted as a superset.
    lits: Optional[List[bytes]] = []
    class_seqs: Optional[List[tuple]] = []
    seq_asts: List[A.Node] = []
    covered = True
    for t in asts:
        route, plan = pattern_route(t)
        if route == "literals":
            lits.extend(plan)
        elif route == "seqs":
            class_seqs.extend(plan)
            seq_asts.append(t)
        else:
            covered = False
    lits = sorted(set(lits)) or None
    if lits is not None and len(lits) > 512:
        lits, covered = None, False
    class_seqs = sorted(set(class_seqs)) or None
    if class_seqs is not None and len(class_seqs) > 32:
        class_seqs, covered = None, False

    # union automaton of the seq-routed patterns (candidate generator
    # for the ensemble's seq member — same superset trust as the
    # whole-batch dfa; exactness still host-verified per pattern).
    # Short literal factors (< 7 bytes: no aligned core word at every
    # phase, so the XOR filter can't serve them) join the union for
    # free — the member's per-word cost is independent of what the
    # automaton recognizes, while each short costs ~17 fused VPU
    # ops/word in a compare bucket.
    def _union_dfa(ts):
        try:
            d = build_dfa(ts, unanchored=True, state_cap=1024)
        except (NotAutomatable, DFABlowup):
            return None, None
        ml: Optional[int] = 0
        for t in ts:
            m = A.max_len(t)
            ml = None if (m is None or ml is None) else max(ml, m)
        return d, ml

    seq_dfa: Optional[DFA] = None
    seq_max_len: Optional[int] = None
    seq_dfa_shorts: Optional[DFA] = None
    seq_shorts_max_len: Optional[int] = None
    if seq_asts and class_seqs:
        seq_dfa, seq_max_len = _union_dfa(seq_asts)
        shorts = [l for l in (lits or []) if len(l) < 7]
        if shorts and seq_dfa is not None:
            seq_dfa_shorts, seq_shorts_max_len = _union_dfa(
                seq_asts + [A.literal_string(l) for l in shorts]
            )

    alpha_plan: Optional[tuple] = None
    if not covered:
        # factor-less patterns: the mandatory class-run prefilter is
        # the device tier above the gather-DFA — and the ONLY device
        # tier for backrefs / state-blowup patterns (dfa is None)
        from grab_tpu_torch.regex.alphabet import best_class_run

        alpha_plan = best_class_run(asts)

    caps = any(A.has_captures(t) for t in asts)
    anchors = any(A.has_anchors(t) for t in asts)
    backrefs = any(A.has_backrefs(t) for t in asts)
    # exact DFA offsets are only trusted when the automaton recognizes
    # precisely the language: no assertions and no over-approximated
    # constructs; otherwise every candidate goes through the host engine.
    needs_verify = anchors or backrefs or dfa is None

    return CompiledPattern(
        patterns=pats,
        asts=asts,
        dfa=dfa,
        matchers=matchers,
        min_len=mn,
        min_lens=min_lens,
        max_len=mx,
        literals=lits,
        class_seqs=class_seqs,
        covered=covered,
        alpha_plan=alpha_plan,
        seq_dfa=seq_dfa,
        seq_max_len=seq_max_len,
        seq_dfa_shorts=seq_dfa_shorts,
        seq_shorts_max_len=seq_shorts_max_len,
        has_captures=caps,
        needs_verify=needs_verify,
        literal_mode=literal_mode,
    )


def compile_pattern(pattern, literal_mode: bool = False, **kw) -> CompiledPattern:
    return compile_multi([pattern], literal_mode=literal_mode, **kw)
