"""Monotone stream movement (counterpart of g4s_tpu/ops/shifts.py).

Four primitives that move data along a flat stream:

  spread(x, d, T)     forward scatter:  out[i + d[i]] = x[i], d monotone
  compact(x, d, T)    backward move:    slot p's element lands at p - d[p]
  bitfill(x, bits, T) doubling broadcast from run heads
  runsum(x, off, T)   per-run sums accumulated at run heads

The reference builds all four from T static rolls and selects, because a
TPU has no fast scatter or gather. On a GPU `spread` and `compact` are one
index copy each: the elements they move, and where they land, are the
same (the reference's distances guarantee distinct targets); only slots no
element lands on may differ, and the reference calls those garbage
(compact) or fills them (spread). `bitfill` and `runsum` keep the log-step
rolls: runsum's tree order makes f64 sums bit-identical to the reference's,
and bitfill reads other slots' bits in later stages, which one gather would
not.

Every function moves along the last dimension, so a (k, m) tensor moves k
streams under one distance array.
"""

from __future__ import annotations

import torch


def stages_for(max_dist: int) -> int:
    """Number of shift stages needed for distances in [0, max_dist]."""
    return max(int(max_dist).bit_length(), 0)


def compact(xs, d: torch.Tensor, T: int):
    """Move the element at slot p back to slot p - d[p]; d monotone
    non-decreasing over live elements, dead slots d = 0 (their values are
    garbage unless overwritten). xs: a tensor or a tuple of tensors moved
    together. T is kept for the reference's signature: the move is one
    index copy, whatever the distances."""
    single = not isinstance(xs, (tuple, list))
    ts = (xs,) if single else tuple(xs)
    m = d.shape[0]
    p = torch.arange(m, device=d.device)
    # elements that stay need no write; every mover has its own target, and
    # the stayers' slots and the dump slot m absorb nothing else
    tgt = torch.where(d > 0, p - d, m)
    out = []
    for x in ts:
        buf = x.new_empty(x.shape[:-1] + (m + 1,))
        buf[..., :m] = x
        buf.index_copy_(x.dim() - 1, tgt, x)
        out.append(buf[..., :m])
    return out[0] if single else tuple(out)


def spread(x: torch.Tensor, d: torch.Tensor, T: int, *, fill=0):
    """out[i + d[i]] = x[i] for live slots (d[i] >= 0, monotone
    non-decreasing over live slots, targets strictly increasing); slots
    nobody lands on read `fill`. One index copy (T kept for the
    reference's signature)."""
    m = d.shape[0]
    p = torch.arange(m, device=d.device)
    tgt = torch.where(d >= 0, p + d, m)
    buf = torch.full(x.shape[:-1] + (m + 1,), fill, dtype=x.dtype,
                     device=x.device)
    buf.index_copy_(x.dim() - 1, tgt, x)
    return buf[..., :m]


def bitfill(x: torch.Tensor, bits: torch.Tensor, T: int):
    """After all stages, slot k holds the value of slot
    k - (bits[k] mod 2^T) when bits[k] is k's offset in its run: each run
    head is broadcast down its run. Cyclic wrap is harmless: a slot
    k < 2^t always has bits[k] <= k, so bit t cannot be set there."""
    for t in range(T):
        m = ((bits >> t) & 1) != 0
        x = torch.where(m, torch.roll(x, 1 << t, dims=-1), x)
    return x


def runsum(x: torch.Tensor, off: torch.Tensor, T: int):
    """off[k] = position of k within its contiguous run (0 at head).
    Returns a tensor whose run-head slots hold the run sums (other slots
    hold partial suffix sums), by exact binary-tree adds in the
    reference's order: after stage t, slot k holds the sum of
    x[k .. min(k + 2^(t+1) - 1, run end)]."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for t in range(T):
        dt = 1 << t
        same = torch.roll(off, -dt) == off + dt   # partner dt deeper in run
        x = x + torch.where(same, torch.roll(x, -dt, dims=-1), zero)
    return x
