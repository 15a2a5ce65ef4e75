"""Multi-literal prefilter scan at byte granularity (plain PyTorch).

Finds every position where one of K literal factors begins, with
shifted byte-plane compares: elementwise work with no sequential state,
on whichever device the data lies. For each literal, position i matches
iff data[i+j] == lit[j] for all j. Only the first PREFIX_CAP bytes are
compared (longer literals are confirmed on the host; a prefix hit is
already a candidate, and candidates are a superset by design).

The JAX package computes this with jnp outside any hand-written kernel
(grab_tpu/ops/literal_scan.py), for its byte-level sharded scan
(parallel/scan_step.make_sharded_scan). The port's scan routes use the
word kernels instead (ops/corewords.py); this contract is kept for
make_sharded_scan and as the byte-granular oracle of those kernels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

PREFIX_CAP = 8


def literal_matrix(literals: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack literals into a [K, PREFIX_CAP] byte matrix plus length
    vector; bytes past a literal's length are wildcards."""
    k = len(literals)
    mat = np.zeros((k, PREFIX_CAP), dtype=np.uint8)
    lens = np.zeros((k,), dtype=np.int32)
    for i, lit in enumerate(literals):
        p = lit[:PREFIX_CAP]
        mat[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return mat, lens


def literal_scan_bitmap(
    lit_mat,  # uint8 [K, PREFIX_CAP] (numpy or tensor)
    lengths: Sequence[int],  # per-literal (capped) lengths
    data: torch.Tensor,  # uint8 [N]
) -> torch.Tensor:
    """bool [N] on data's device: out[i] == True iff some literal's
    (capped) prefix starts at i.

    Built from shifted slices — shifted_j[i] = data[i+j] with a zero
    tail — so the work is K·L elementwise compares, no gathers.
    Zero-padding can only suppress matches that would run past the end
    of the buffer, which are not real matches of in-buffer data."""
    n = data.shape[0]
    cap = max(lengths)
    mat = [[int(b) for b in row] for row in np.asarray(lit_mat, dtype=np.uint8)]
    padded = torch.cat([data, data.new_zeros((cap - 1,))]) if cap > 1 else data
    shifted = [padded[j : j + n] for j in range(max(cap, 1))]
    hit = torch.zeros((n,), dtype=torch.bool, device=data.device)
    for k, length in enumerate(lengths):
        eq = shifted[0] == mat[k][0]
        for j in range(1, length):
            eq &= shifted[j] == mat[k][j]
        hit |= eq
    return hit
