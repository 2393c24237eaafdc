"""Frozen peaks and the byte and operation counts of the port's kernels.

The peaks, the operation counts and the bytes of one launch are a frozen
copy of `chip_smoke.py`'s (its constants and the expressions of
`kernels_at_main_shapes` and `kernels_at_irregular_shapes`), kept here so
that a change to the program cannot move the yardstick. A kernel's bound
is the larger of its bytes over the card's memory rate and its f32
operations over the card's f32 rate; every input byte is counted once and
every output byte once.

`solve_pass_bound_s` is the benchmark's own: chip_smoke.py reads each
launch's writes from its data, which a traced run of the served path
cannot see, so it puts every lane's V writes of a solve on its first
launch. It counts main-mode launches only: a dirty-driven launch walks the
rows its dirty table marks, which depend on the data and are not
observable outside the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# operations per field element, counted from the kernels' sources
PASS_OPS = 14    # 3 add + 3 min (cross), 1 min, flag mul+add+cmp, 2 x (add+min) scans
PRED_OPS = 26    # 8 x (add+cmp+select), has: mul+add+3 cmp, flag: mul+add+cmp
XLANE_OPS = 2    # an extended lane's edge: one add and one min a batch lane
PASS_LANES = 8   # batch lanes of one pass block (a dirty-table entry covers them)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes or operations, whichever bounds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def pass_bytes(Rp: int, Cp: int, Bp: int, *, written: int = 0, dirty: bool = False,
               xlist_bytes: int = 0) -> int:
    """One pass that reads the whole field: the field, the five planes it
    reads (cross and level 0 of the chain weights), the extended lanes' lists,
    the dirty table read and written where it has one, and one write of each
    element it changed (`written`)."""
    nb = Bp // PASS_LANES
    return (Rp * Cp * Bp + 5 * Rp * Cp + (2 * nb * Rp if dirty else 0) + written) * 4 \
        + xlist_bytes


def pass_ops(Rp: int, Cp: int, Bp: int, *, xlist_edges: int = 0) -> int:
    return PASS_OPS * Rp * Cp * Bp + XLANE_OPS * xlist_edges * Bp


def pred_bytes(Rp: int, Cp: int, Bp: int, V: int) -> int:
    """The class-pred kernel's int8 mode: the field, the int8 table written
    and the eight in-edge weight planes."""
    return Rp * Cp * Bp * 4 + V * Bp + 8 * Rp * Cp * 4


def pred_ops(Rp: int, Cp: int, Bp: int) -> int:
    return PRED_OPS * Rp * Cp * Bp


def solve_pass_bound_s(*, Rp: int, Cp: int, Bp: int, V: int, B: int, steps: int,
                       launches: int) -> float:
    """The pass kernel's bound over `steps` cold solves of B lanes by
    `launches` main-mode launches, each of which reads the whole field and
    its planes. Over a solve every real element of every lane is written at
    least once (no vertex of the cells' maps is lethal, so every label ends
    finite): V * B writes a solve."""
    full = bound_s(pass_bytes(Rp, Cp, Bp), pass_ops(Rp, Cp, Bp))
    return launches * full + steps * V * B * 4 / HBM_BYTES_PER_S


def pred_bound_s(*, Rp: int, Cp: int, Bp: int, V: int, launches: int) -> float:
    return launches * bound_s(pred_bytes(Rp, Cp, Bp, V), pred_ops(Rp, Cp, Bp))
