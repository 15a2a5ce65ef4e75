"""Class-sequence prefilter at byte granularity (plain PyTorch).

Generalizes the literal prefilter: a pattern's matches must begin with
one of a small set of byte-class sequences (extracted by
ast.prefix_class_sequences). Position i is a candidate iff for some
sequence, byte i+j lies in class j for all j. Class membership is
computed as range tests (pure arithmetic — no tables, no gathers), so
the work stays elementwise even for patterns with no literal factor
(e.g. ``\\d+\\.\\d+`` → [0-9],[0-9.]…).

The JAX package computes this with jnp (grab_tpu/ops/class_prefilter.py);
the port's scan routes use the class-sequence word kernel
(ops/classseq.py), whose compiled form this module shares.
"""

from __future__ import annotations

import torch

from grab_tpu_torch.ops.classseq import PREFIX_CAP, CompiledSeqs, compile_sequences

__all__ = ["PREFIX_CAP", "CompiledSeqs", "compile_sequences", "class_prefilter_bitmap"]


def _membership(plane: torch.Tensor, ranges) -> torch.Tensor:
    """bool: plane's bytes in the union of inclusive (lo, hi) ranges;
    the full range 0..255 is always true."""
    hit = None
    for lo, hi in ranges:
        if lo == hi:
            t = plane == lo
        elif lo == 0 and hi == 255:
            return torch.ones_like(plane, dtype=torch.bool)
        else:
            t = (plane >= lo) & (plane <= hi)
        hit = t if hit is None else hit | t
    return hit


def class_prefilter_bitmap(seqs: CompiledSeqs, data: torch.Tensor) -> torch.Tensor:
    """bool [N] on data's device: candidate start positions (superset).
    data: uint8 [N]; the tail past the buffer reads as zero bytes."""
    n = data.shape[0]
    x = data.to(torch.int32)
    cap = max(len(s) for s in seqs)
    padded = torch.cat([x, x.new_zeros((cap - 1,))]) if cap > 1 else x
    shifted = [padded[j : j + n] for j in range(cap)]
    hit = torch.zeros((n,), dtype=torch.bool, device=data.device)
    for seq in seqs:
        eq = _membership(shifted[0], seq[0])
        for j in range(1, len(seq)):
            eq = eq & _membership(shifted[j], seq[j])
        hit |= eq
    return hit
