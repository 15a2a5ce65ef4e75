"""Numpy golden-model scanners.

These define the *contract* of the device kernels:

  * ``dfa_scan_ends``: run the search DFA sequentially over a buffer and
    return the boolean "a match ends just after byte i" vector. This is
    the obviously-correct per-byte loop the device DFA walk must
    reproduce (the kernel parallelizes it over streams with halos).
  * ``literal_scan_starts``: positions where any of a set of literals
    begins, the contract of the literal prefilter (ops/literal_scan.py).
  * ``block_counts``: reduce an end-bitmap to per-block candidate counts,
    the compact fixed-shape result the device ships back to the host
    (SURVEY §7: fixed-size match buffers + overflow flag).
"""

from __future__ import annotations

from typing import List

import numpy as np

from grab_tpu_torch.regex.dfa import DFA


def dfa_scan_ends(dfa: DFA, data: np.ndarray) -> np.ndarray:
    """Sequential DFA scan. data: uint8[N]. Returns bool[N] where
    out[i] == True iff the search automaton is in an accepting state
    after consuming data[..i] — i.e. some match ends at position i+1."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    out = np.zeros(n, dtype=bool)
    cls = dfa.class_map[data]  # [N]
    table = dfa.table
    accept = dfa.accept_mask
    s = dfa.start
    for i in range(n):
        s = table[s, cls[i]]
        out[i] = accept[s]
    return out


def dfa_scan_ends_fast(dfa: DFA, data: np.ndarray) -> np.ndarray:
    """Same contract as dfa_scan_ends but O(n) numpy-light; used for
    bigger test corpora. Still sequential (it is the oracle, not the
    product)."""
    data = np.asarray(data, dtype=np.uint8)
    cls = dfa.class_map[data].tolist()
    table = dfa.table.tolist()
    accept = dfa.accept_mask.tolist()
    s = dfa.start
    out = np.zeros(len(cls), dtype=bool)
    for i, c in enumerate(cls):
        s = table[s][c]
        if accept[s]:
            out[i] = True
    return out


def literal_scan_starts(literals: List[bytes], data: bytes) -> np.ndarray:
    """bool[N]: out[i] == True iff some literal matches starting at i."""
    n = len(data)
    out = np.zeros(n, dtype=bool)
    for lit in literals:
        start = 0
        while True:
            idx = data.find(lit, start)
            if idx < 0:
                break
            out[idx] = True
            start = idx + 1
    return out


def block_counts(bitmap: np.ndarray, block: int) -> np.ndarray:
    """int32[ceil(N/block)]: number of set bits per block."""
    n = bitmap.shape[0]
    nb = -(-n // block)
    padded = np.zeros(nb * block, dtype=np.int32)
    padded[:n] = bitmap.astype(np.int32)
    return padded.reshape(nb, block).sum(axis=1).astype(np.int32)
