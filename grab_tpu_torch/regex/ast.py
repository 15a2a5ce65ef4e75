"""Regex AST node types and static analyses.

The AST is byte-oriented (no UTF mode), matching the reference engine's
configuration: grab compiles with options=0 and C-locale tables
(greppin src/grab.cc:106), so the subject is a byte string and
`.` excludes ``\n``.

Analyses provided here:
  * ``min_len``  — minimum match length in bytes; the TPU build uses it
    for the whole-file skip prune exactly like the reference uses
    PCRE_INFO_MINLENGTH (grab.cc:120, 133-135).
  * ``max_len``  — maximum match length (None = unbounded); bounds the
    halo/overlap the scan kernels need for cross-block exactness.
  * ``mandatory_literals`` — a set of literal byte strings such that any
    match must contain at least one of them; drives the Teddy-style
    prefilter kernel.
  * ``has_captures`` / anchors / zero-width info used by the engine to
    decide PCRE1-quirk behavior (see grab.cc:171-179 ovector[3]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Node types
# ---------------------------------------------------------------------------


class Node:
    """Base class for AST nodes."""



@dataclass(frozen=True)
class Empty(Node):
    """Matches the empty string."""



@dataclass(frozen=True)
class CharClass(Node):
    """A set of bytes, stored as a 256-bit bitmask (int)."""

    mask: int  # bit b set <=> byte b is in the class


    def contains(self, byte: int) -> bool:
        return bool((self.mask >> byte) & 1)

    def bytes(self):
        m = self.mask
        out = []
        while m:
            b = (m & -m).bit_length() - 1
            out.append(b)
            m &= m - 1
        return out

    def count(self) -> int:
        return bin(self.mask).count("1")


@dataclass(frozen=True)
class Concat(Node):
    parts: tuple



@dataclass(frozen=True)
class Alt(Node):
    branches: tuple



@dataclass(frozen=True)
class Repeat(Node):
    node: Node
    lo: int
    hi: Optional[int]  # None = unbounded
    lazy: bool = False
    possessive: bool = False



@dataclass(frozen=True)
class Group(Node):
    node: Node
    capturing: bool
    index: int  # capture index (1-based) if capturing else 0



@dataclass(frozen=True)
class Anchor(Node):
    """Zero-width assertion.

    kind is one of: 'bos' (^ or \\A), 'eos' ($), 'abs_eos' (\\z),
    'eos_nl' (\\Z), 'wordb' (\\b), 'nwordb' (\\B).
    """

    kind: str



@dataclass(frozen=True)
class Backref(Node):
    """Backreference \\N. Not DFA-able; forces host-only matching.
    ``ci`` marks a backreference compiled under (?i): the referenced
    text is compared case-insensitively (C-locale folding), matching
    libpcre's caseless OP_REF (grab.cc:106 compiles the full PCRE
    surface including these)."""

    index: int
    ci: bool = False


@dataclass
class Call(Node):
    """Subroutine call (?N) / (?R) / (?&name) / (?P>name): match the
    referenced capturing group's pattern (0 = the whole pattern) at
    the current position. PCRE1 semantics — the reference's engine
    (grab.cc:106) — make the call ATOMIC (no backtracking into a
    completed call); PCRE2 relaxed this in 10.30+, a documented
    deviation vs grep -P corner cases. Not automatable; routes to the
    backtracking engine like backrefs. ``index`` is resolved after
    parsing (named/forward references), hence the mutable node."""

    index: int
    name: "Optional[str]" = None


@dataclass(frozen=True)
class Define(Node):
    """(?(DEFINE)...) group: never matched inline (zero-width no-op at
    runtime); exists so its named subpatterns can be called. The body
    still participates in group numbering and subprogram compilation."""

    node: Node


@dataclass
class CondR(Node):
    """Recursion condition (?(R)yes|no) and its per-group forms
    (?(RN)../(?(R&name)..): yes iff the matcher is currently inside a
    subroutine call / recursion — any call when ``ref`` is None, the
    whole pattern when ref == 0 ((?(R0)), or specifically a call whose
    MOST RECENT frame targets group ``ref`` (PCRE's documented (?(Rn)
    semantics). ``name`` holds an unresolved (?(R&name) reference until
    the post-parse resolve pass (mutable node, like Call). Backtracking
    engine only (the VM threads the innermost call target); the
    candidate automaton over-approximates as Alt((yes, no)) like
    Cond. Reference: libpcre OP_RREF via grab.cc:106."""

    yes: Node
    no: Node
    ref: "Optional[int]" = None  # None = any recursion
    name: "Optional[str]" = None


@dataclass
class Cond(Node):
    """Conditional group (?(n)yes|no) testing whether capturing group
    ``ref`` has matched. Lookaround conditions (?(?=..)..) are
    desugared to Alt at parse time; group-number/name conditions need
    runtime group state, so has_backrefs() returns True and such
    patterns route to the exact backtracking engine exactly like
    backreference patterns (the reference gets them from libpcre,
    grab.cc:101-123). ``name`` holds a not-yet-defined named condition
    ((?(<n>)..)(?<n>..) — libpcre accepts named forward references)
    resolved after the parse, hence the mutable node. The static
    analyses treat Cond as Alt((yes, no)) — an over-approximation of
    the language, sound for candidate generation."""

    ref: int
    yes: Node
    no: Node
    name: "Optional[str]" = None


@dataclass(frozen=True)
class Look(Node):
    """Zero-width lookaround assertion: (?=..) (?!..) (?<=..) (?<!..).

    Device automata treat it as epsilon (a superset — dropping an
    assertion only widens the candidate set); the backtracking engine
    evaluates it exactly. Lookbehind bodies must be fixed-length
    (PCRE's own restriction), enforced at program-compile time.
    """

    node: Node
    ahead: bool  # True: lookahead; False: lookbehind
    negate: bool



# ---------------------------------------------------------------------------
# Byte-class helpers
# ---------------------------------------------------------------------------

ALL_BYTES_MASK = (1 << 256) - 1
NEWLINE_MASK = 1 << 0x0A


def fold_case_mask(mask: int) -> int:
    """Close a byte-class mask under ASCII case folding (the (?i) flag
    with C-locale tables, matching the reference's pcre_maketables)."""
    lower = (mask >> 0x61) & ((1 << 26) - 1)
    upper = (mask >> 0x41) & ((1 << 26) - 1)
    both = lower | upper
    return mask | (both << 0x61) | (both << 0x41)


def mask_of(byte_values) -> int:
    m = 0
    for b in byte_values:
        m |= 1 << b
    return m


def mask_range(lo: int, hi: int) -> int:
    """Mask for bytes lo..hi inclusive."""
    return ((1 << (hi - lo + 1)) - 1) << lo


DIGIT_MASK = mask_range(0x30, 0x39)
UPPER_MASK = mask_range(0x41, 0x5A)
LOWER_MASK = mask_range(0x61, 0x7A)
ALPHA_MASK = UPPER_MASK | LOWER_MASK
ALNUM_MASK = ALPHA_MASK | DIGIT_MASK
WORD_MASK = ALNUM_MASK | (1 << 0x5F)  # [A-Za-z0-9_]
SPACE_MASK = mask_of([0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D])
HSPACE_MASK = mask_of([0x20, 0x09])
XDIGIT_MASK = DIGIT_MASK | mask_range(0x41, 0x46) | mask_range(0x61, 0x66)
PUNCT_MASK = (
    mask_range(0x21, 0x2F)
    | mask_range(0x3A, 0x40)
    | mask_range(0x5B, 0x60)
    | mask_range(0x7B, 0x7E)
)
PRINT_MASK = mask_range(0x20, 0x7E)
GRAPH_MASK = mask_range(0x21, 0x7E)
CNTRL_MASK = mask_range(0x00, 0x1F) | (1 << 0x7F)
DOT_MASK = ALL_BYTES_MASK & ~NEWLINE_MASK  # '.' excludes \n in default PCRE


def literal(byte: int) -> CharClass:
    return CharClass(1 << byte)


def literal_string(data: bytes) -> Node:
    if len(data) == 0:
        return Empty()
    if len(data) == 1:
        return literal(data[0])
    return Concat(tuple(literal(b) for b in data))


# ---------------------------------------------------------------------------
# Analyses
# ---------------------------------------------------------------------------


def min_len(node: Node) -> int:
    """Minimum match length in bytes (the PCRE_INFO_MINLENGTH analog)."""
    if isinstance(node, (Empty, Anchor, Look)):
        return 0
    if isinstance(node, CharClass):
        return 1
    if isinstance(node, Concat):
        return sum(min_len(p) for p in node.parts)
    if isinstance(node, Alt):
        return min(min_len(b) for b in node.branches)
    if isinstance(node, Repeat):
        return node.lo * min_len(node.node)
    if isinstance(node, Group):
        return min_len(node.node)
    if isinstance(node, Backref):
        return 0  # conservative: referenced group may have matched ""
    if isinstance(node, (Cond, CondR)):
        return min(min_len(node.yes), min_len(node.no))
    if isinstance(node, (Call, Define)):
        return 0  # conservative: called pattern may match empty;
        # DEFINE matches nothing inline
    raise TypeError(f"unknown node {node!r}")


def max_len(node: Node) -> Optional[int]:
    """Maximum match length in bytes, or None if unbounded."""
    if isinstance(node, (Empty, Anchor, Look)):
        return 0
    if isinstance(node, CharClass):
        return 1
    if isinstance(node, Concat):
        total = 0
        for p in node.parts:
            m = max_len(p)
            if m is None:
                return None
            total += m
        return total
    if isinstance(node, Alt):
        best = 0
        for b in node.branches:
            m = max_len(b)
            if m is None:
                return None
            best = max(best, m)
        return best
    if isinstance(node, Repeat):
        if node.hi is None:
            inner = max_len(node.node)
            return 0 if inner == 0 else None
        m = max_len(node.node)
        return None if m is None else node.hi * m
    if isinstance(node, Group):
        return max_len(node.node)
    if isinstance(node, Backref):
        return None
    if isinstance(node, (Cond, CondR)):
        my, mn_ = max_len(node.yes), max_len(node.no)
        if my is None or mn_ is None:
            return None
        return max(my, mn_)
    if isinstance(node, Call):
        return None  # recursion: unbounded
    if isinstance(node, Define):
        return 0
    raise TypeError(f"unknown node {node!r}")


def has_captures(node: Node) -> bool:
    """True if the pattern contains at least one capturing group.

    The reference calls pcre_exec with a 3-slot ovector (grab.cc:171,178);
    with >=1 capturing group PCRE1 returns 0 which grab treats as
    no-match (grab.cc:179), so such patterns silently produce no output.
    The engine replicates that quirk only in pcre1-compat mode.
    """
    if isinstance(node, Group):
        return node.capturing or has_captures(node.node)
    if isinstance(node, Concat):
        return any(has_captures(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(has_captures(b) for b in node.branches)
    if isinstance(node, (Repeat, Look)):
        return has_captures(node.node)
    if isinstance(node, (Cond, CondR)):
        return has_captures(node.yes) or has_captures(node.no)
    if isinstance(node, Define):
        return has_captures(node.node)
    return False


def has_backrefs(node: Node) -> bool:
    if isinstance(node, Backref):
        return True
    if isinstance(node, Group):
        return has_backrefs(node.node)
    if isinstance(node, Concat):
        return any(has_backrefs(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(has_backrefs(b) for b in node.branches)
    if isinstance(node, (Repeat, Look)):
        return has_backrefs(node.node)
    if isinstance(node, (Cond, CondR)):
        return True  # needs runtime state, like a backreference
    if isinstance(node, (Call, Define)):
        return True  # subroutine calls need the backtracking engine
    return False


def has_anchors(node: Node) -> bool:
    """True if the pattern contains any zero-width assertion.

    Assertion conditions are over-approximated (treated as epsilon) in
    the DFA used for device-side candidate generation, so patterns with
    anchors always require host-side exact verification of candidates.
    """
    if isinstance(node, (Anchor, Look)):
        return True
    if isinstance(node, Group):
        return has_anchors(node.node)
    if isinstance(node, Concat):
        return any(has_anchors(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(has_anchors(b) for b in node.branches)
    if isinstance(node, Repeat):
        return has_anchors(node.node)
    if isinstance(node, (Cond, CondR)):
        return has_anchors(node.yes) or has_anchors(node.no)
    if isinstance(node, Call):
        return True  # conservative: the called body may assert
    if isinstance(node, Define):
        return has_anchors(node.node)
    return False


def may_match_newline(node: Node) -> bool:
    """Conservative: True if any matchable byte class contains ``\\n``.

    When False, every match lies within one line, so the host replay can
    narrow exact scans to the lines overlapping kernel candidate blocks.
    """
    if isinstance(node, CharClass):
        return node.contains(0x0A)
    if isinstance(node, Group):
        return may_match_newline(node.node)
    if isinstance(node, Concat):
        return any(may_match_newline(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(may_match_newline(b) for b in node.branches)
    if isinstance(node, Repeat):
        return may_match_newline(node.node)
    if isinstance(node, Backref):
        return True  # unknown content
    if isinstance(node, (Cond, CondR)):
        return may_match_newline(node.yes) or may_match_newline(node.no)
    if isinstance(node, Call):
        return True  # called body is opaque here
    return False


# ---------------------------------------------------------------------------
# Mandatory-literal extraction (prefilter factors)
# ---------------------------------------------------------------------------

_MAX_LITERAL_SET = 64  # cap on number of alternative literals
_MAX_CLASS_EXPANSION = 4  # expand char classes with <= this many bytes


@dataclass
class _LitInfo:
    """Literal analysis of a subexpression.

    ``exact``: set of byte strings = exactly the language (if small), or
    None. ``required``: set of literals such that every match contains at
    least one member as a substring, or None if no such (useful) set.
    """

    exact: Optional[frozenset]
    required: Optional[frozenset]


def _lit_info(node: Node) -> _LitInfo:
    if isinstance(node, (Empty, Anchor, Look)):
        # zero-width: contributes no bytes to the match extent
        return _LitInfo(frozenset({b""}), None)
    if isinstance(node, Backref):
        return _LitInfo(None, None)
    if isinstance(node, CharClass):
        bs = node.bytes()
        if 0 < len(bs) <= _MAX_CLASS_EXPANSION:
            ex = frozenset(bytes([b]) for b in bs)
            return _LitInfo(ex, ex)
        return _LitInfo(None, None)
    if isinstance(node, Group):
        return _lit_info(node.node)
    if isinstance(node, Call):
        return _LitInfo(None, None)
    if isinstance(node, Define):
        return _LitInfo(frozenset({b""}), None)  # zero-width inline
    if isinstance(node, (Cond, CondR)):
        # language ⊆ L(yes) ∪ L(no): union the required sets like Alt;
        # never exact (which branch runs depends on runtime state)
        iy, in_ = _lit_info(node.yes), _lit_info(node.no)
        required = None
        if iy.required is not None and in_.required is not None:
            u = iy.required | in_.required
            if len(u) <= _MAX_LITERAL_SET:
                required = u
        return _LitInfo(None, required)
    if isinstance(node, Alt):
        exacts, reqs = [], []
        for b in node.branches:
            i = _lit_info(b)
            exacts.append(i.exact)
            reqs.append(i.required)
        exact = None
        if all(e is not None for e in exacts):
            u = frozenset().union(*exacts)
            if len(u) <= _MAX_LITERAL_SET:
                exact = u
        required = None
        if all(r is not None for r in reqs):
            u = frozenset().union(*reqs)
            if len(u) <= _MAX_LITERAL_SET:
                required = u
        return _LitInfo(exact, required)
    if isinstance(node, Repeat):
        inner = _lit_info(node.node)
        if node.lo == 0:
            return _LitInfo(None, None)
        # At least one occurrence: inner required literals still required.
        exact = None
        if node.lo == node.hi and inner.exact is not None:
            combos = frozenset({b""})
            ok = True
            for _ in range(node.lo):
                combos = frozenset(a + c for a in combos for c in inner.exact)
                if len(combos) > _MAX_LITERAL_SET:
                    ok = False
                    break
            if ok:
                exact = combos
        return _LitInfo(exact, inner.required)
    if isinstance(node, Concat):
        # exact: cross product of parts (bounded)
        exact = frozenset({b""})
        for p in node.parts:
            pi = _lit_info(p)
            if exact is not None and pi.exact is not None:
                exact = frozenset(a + c for a in exact for c in pi.exact)
                if len(exact) > _MAX_LITERAL_SET:
                    exact = None
            else:
                exact = None
            if exact is None:
                break
        if exact is not None:
            return _LitInfo(exact, exact)
        # required: best single segment. Find maximal runs of exact parts
        # and treat each run's cross-product as one candidate required set;
        # fall back to any single part's required set.
        best: Optional[frozenset] = None

        def score(s: Optional[frozenset]) -> float:
            if not s:
                return -1.0
            if any(len(x) == 0 for x in s):
                return -1.0
            # prefer longer minimum literal, then fewer alternatives
            return min(len(x) for x in s) * 1000 - len(s)

        run: Optional[frozenset] = frozenset({b""})
        for p in node.parts:
            pi = _lit_info(p)
            if pi.exact is not None and run is not None:
                nxt = frozenset(a + c for a in run for c in pi.exact)
                if len(nxt) <= _MAX_LITERAL_SET:
                    run = nxt
                else:
                    if score(run) > score(best):
                        best = run
                    run = frozenset({b""})
            else:
                if run is not None and score(run) > score(best):
                    best = run
                run = frozenset({b""})
                if score(pi.required) > score(best):
                    best = pi.required
        if run is not None and score(run) > score(best):
            best = run
        if best is not None and score(best) < 0:
            best = None
        return _LitInfo(None, best)
    raise TypeError(f"unknown node {node!r}")


_MAX_CLASS_SEQS = 16


def prefix_class_sequences(node: Node, k: int) -> Optional[list]:
    """Class-mask sequences covering every match's first ``k`` bytes.

    Returns a list of tuples of 256-bit masks: any match's first
    min(k, len(seq)) bytes must satisfy one of the sequences
    (byte j ∈ seq[j]). This drives the device class-sequence prefilter —
    the generalization of the literal prefilter to range tests, used
    when no literal factor exists (e.g. ``\\d+\\.\\d+``). Returns None
    when no useful sequence exists (alternation blowup or minlen 0).
    """

    def walk(n, budget):
        """Returns list of (tuple_of_masks, exhausted) covering matches
        of ``n``: tuple holds the first bytes; exhausted=True iff the
        tuple covers ALL bytes of every match of n (so a following
        element may extend it)."""
        if budget <= 0:
            return None
        if isinstance(n, (Empty, Anchor, Look)):
            # zero-width: dropping the assertion over-approximates
            return [((), True)]
        if isinstance(n, (Backref, Call)):
            return None
        if isinstance(n, Define):
            return [((), True)]  # zero-width inline
        if isinstance(n, CharClass):
            return [(((n.mask),), True)]
        if isinstance(n, Group):
            return walk(n.node, budget)
        if isinstance(n, (Alt, Cond, CondR)):
            branches = n.branches if isinstance(n, Alt) else (n.yes, n.no)
            out = []
            for b in branches:
                r = walk(b, budget - len(out))
                if r is None:
                    return None
                out.extend(r)
                if len(out) > budget:
                    return None
            return out
        if isinstance(n, Concat):
            seqs = [((), True)]
            for p in n.parts:
                nxt = []
                done = []
                for masks, ex in seqs:
                    if not ex or len(masks) >= k:
                        done.append((masks, False))
                        continue
                    r = walk(p, budget)
                    if r is None:
                        return None
                    for pm, pex in r:
                        cat = (masks + pm)[:k]
                        nxt.append((cat, ex and pex and len(masks + pm) <= k))
                seqs = done + nxt
                if len(seqs) > budget:
                    return None
            return seqs
        if isinstance(n, Repeat):
            if n.lo == 0:
                # optional: contributes either nothing or its content —
                # treat as a stopper (sequence ends here)
                return [((), False)]
            inner = walk(n.node, budget)
            if inner is None:
                return None
            if n.lo == 1:
                # one mandatory occurrence, then unknown repetition
                return [(m, False) for m, _ in inner]
            # lo >= 2: repeat the inner sequences (bounded expansion)
            seqs = inner
            for _ in range(min(n.lo, k) - 1):
                nxt = []
                for masks, ex in seqs:
                    if not ex or len(masks) >= k:
                        nxt.append((masks, False))
                        continue
                    for pm, pex in inner:
                        nxt.append(((masks + pm)[:k], ex and pex))
                seqs = nxt
                if len(seqs) > _MAX_CLASS_SEQS * 4:
                    return None
            return [(m, False) for m, _ in seqs]
        raise TypeError(f"unknown node {n!r}")

    r = walk(node, _MAX_CLASS_SEQS)
    if r is None:
        return None
    seqs = set()
    for masks, _ in r:
        if len(masks) == 0:
            return None  # some match may be empty/unconstrained
        seqs.add(tuple(masks))
    if not seqs or len(seqs) > _MAX_CLASS_SEQS:
        return None
    return sorted(seqs)


def first_mask(node: Node) -> Optional[int]:
    """The bytes every match of ``node`` can start with, as a 256-bit
    mask; None when it can match empty or its first byte is not known
    statically (backreferences, calls)."""
    if min_len(node) == 0:
        return None
    if isinstance(node, CharClass):
        return node.mask
    if isinstance(node, (Group, Repeat)):
        return first_mask(node.node)  # a Repeat here has lo >= 1
    if isinstance(node, (Alt, Cond, CondR)):
        branches = node.branches if isinstance(node, Alt) else (node.yes, node.no)
        masks = [first_mask(b) for b in branches]
        if any(m is None for m in masks):
            return None
        out = 0
        for m in masks:
            out |= m
        return out
    if isinstance(node, Concat):
        for p in node.parts:
            if not isinstance(p, (Empty, Anchor, Look, Define)):
                return first_mask(p)  # None when p can match empty
    return None


def _one_class(node: Node) -> Optional[int]:
    """The mask of a repeat body that is one class (groups looked through)."""
    while isinstance(node, Group):
        node = node.node
    return node.mask if isinstance(node, CharClass) else None


def device_class_sequences(node: Node, k: int = 8) -> Optional[list]:
    """Class-mask sequences covering every match's first bytes, as
    ``prefix_class_sequences``, but carried past a pattern's first
    repeat, so that the device member of a ``-H`` batch flags only where
    a longer stretch of the pattern can start:

    * a fixed repeat ``X{n}`` whose sequences each cover all of ``X``'s
      match leaves the sequence open (``[0-9]{3}-[0-9]{4}``: 8 classes);
    * an open repeat of one class ``C{lo,}`` / ``C{lo,hi}`` followed, in
      its concatenation, by a part that cannot match empty gives ``lo``
      copies of ``C`` and then one class, ``C`` ∪ the first byte of what
      follows, and ends there (``qu+x``: ``q u [ux]``); with nothing
      after it, or a part that can match empty, it ends after the
      ``lo`` copies.

    Each sequence is cut at ``k`` classes and is no longer than any
    match it covers. None where no sequence set of at most
    ``_MAX_CLASS_SEQS`` covers every match."""

    def repeat(n, budget):
        inner = walk(n.node, budget)
        if inner is None:
            return None
        seqs = [((), True)]
        for _ in range(n.lo):
            if not any(ex and len(m) < k for m, ex in seqs):
                return [(m, False) for m, _ in seqs]  # copies left over
            nxt = []
            for masks, ex in seqs:
                if not ex or len(masks) >= k:
                    nxt.append((masks, False))
                    continue
                for pm, pex in inner:
                    cat = masks + pm
                    nxt.append((cat[:k], pex and len(cat) <= k))
            seqs = nxt
            if len(seqs) > _MAX_CLASS_SEQS * 4:
                return None
        if n.hi != n.lo:
            return [(m, False) for m, _ in seqs]
        return seqs

    def open_run(n, rest):
        """An open repeat of one class, followed by ``rest``."""
        c = _one_class(n.node)
        follow = first_mask(Concat(tuple(rest))) if rest else None
        masks = (c,) * min(n.lo, k)
        if follow is not None:
            masks = (masks + (c | follow,))[:k]
        return [(masks, False)]

    def walk(n, budget):
        if budget <= 0:
            return None
        if isinstance(n, (Empty, Anchor, Look, Define)):
            return [((), True)]
        if isinstance(n, (Backref, Call)):
            return None
        if isinstance(n, CharClass):
            return [((n.mask,), True)]
        if isinstance(n, Group):
            return walk(n.node, budget)
        if isinstance(n, (Alt, Cond, CondR)):
            branches = n.branches if isinstance(n, Alt) else (n.yes, n.no)
            out = []
            for b in branches:
                r = walk(b, budget - len(out))
                if r is None:
                    return None
                out.extend(r)
                if len(out) > budget:
                    return None
            return out
        if isinstance(n, Concat):
            seqs = [((), True)]
            parts = n.parts
            for i, p in enumerate(parts):
                if not any(ex and len(m) < k for m, ex in seqs):
                    return [(m, False) for m, _ in seqs]  # parts left over
                q = p
                while isinstance(q, Group):
                    q = q.node
                if isinstance(q, Repeat) and q.hi != q.lo and _one_class(q.node) is not None:
                    r = open_run(q, parts[i + 1 :])
                else:
                    r = walk(p, budget)
                if r is None:
                    return None
                nxt = []
                for masks, ex in seqs:
                    if not ex or len(masks) >= k:
                        nxt.append((masks, False))
                        continue
                    for pm, pex in r:
                        cat = masks + pm
                        nxt.append((cat[:k], pex and len(cat) <= k))
                seqs = nxt
                if len(seqs) > budget:
                    return None
            return seqs
        if isinstance(n, Repeat):
            if n.hi != n.lo and _one_class(n.node) is not None:
                return open_run(n, ())
            if n.lo == 0:
                return [((), False)]
            return repeat(n, budget)
        raise TypeError(f"unknown node {n!r}")

    r = walk(node, _MAX_CLASS_SEQS)
    if r is None:
        return None
    seqs = set()
    for masks, _ in r:
        if len(masks) == 0:
            return None  # some match may be empty/unconstrained
        seqs.add(tuple(masks))
    if not seqs or len(seqs) > _MAX_CLASS_SEQS:
        return None
    return sorted(seqs)


def exact_literal(node: Node) -> Optional[bytes]:
    """The one byte string this AST matches, or None if it can match
    anything else (classes, alternations, repeats, anchors, backrefs).
    Non-capturing structure is looked through; a capturing group
    disqualifies nothing here — callers gate on has_captures where the
    PCRE1 ovector quirk applies (engine._make_exact_matcher)."""
    if isinstance(node, Empty):
        return b""
    if isinstance(node, CharClass):
        if node.count() != 1:
            return None
        return bytes([node.bytes()[0]])
    if isinstance(node, Group):
        return exact_literal(node.node)
    if isinstance(node, Concat):
        out = b""
        for part in node.parts:
            lit = exact_literal(part)
            if lit is None:
                return None
            out += lit
        return out
    if isinstance(node, Repeat):
        if node.lo == node.hi:
            lit = exact_literal(node.node)
            return None if lit is None else lit * node.lo
        return None
    return None


def mask_to_ranges(mask: int, max_ranges: int = 8) -> list:
    """Decompose a 256-bit class mask into [lo, hi] byte ranges; if more
    than ``max_ranges`` runs exist, over-approximate with the covering
    range (superset semantics keep the prefilter correct)."""
    ranges = []
    b = 0
    while b < 256:
        if (mask >> b) & 1:
            lo = b
            while b < 256 and (mask >> b) & 1:
                b += 1
            ranges.append((lo, b - 1))
        else:
            b += 1
    if len(ranges) > max_ranges:
        return [(ranges[0][0], ranges[-1][1])]
    return ranges


def mandatory_literals(node: Node) -> Optional[list]:
    """A list of byte strings such that every match contains >= 1 of them.

    Returns None when no useful literal set exists (e.g. ``[a-z]+``); the
    engine then skips the prefilter stage and scans with the DFA kernel
    directly. Mirrors hyperscan's literal-factoring role in the greppin
    branch (greppin README.md:46-50).
    """
    info = _lit_info(node)
    req = info.required
    if req is None:
        return None
    if any(len(x) == 0 for x in req):
        return None
    return sorted(req)
