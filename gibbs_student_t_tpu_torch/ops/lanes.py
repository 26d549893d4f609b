"""The serving slot pool's lane contract, shared by the ``*_lanes`` entries.

Counterpart of ``LANES_GROUP`` in ``gibbs_student_t_tpu/ops/pallas_util.py``
and of ``_check_lanes_gid`` in ``gibbs_student_t_tpu/ops/pallas_chol.py``.
The slot pool (``serve/pool.py``) gives every lane one chain and admits
tenants in whole groups of :data:`LANES_GROUP` lanes, so a tenant's model
and MH constants are the same on every lane of an aligned 16-lane tile
(the tile-uniform ``gid`` contract). A lanes entry therefore reads one
row of constants per tile (the JAX entries' ``[::16]`` stride-slice) and
reduces the lane batch through the grouped form of its kernel, with the
16 lanes of each tile as one group's chains.

``gid`` (one group id per lane) is a witness of that contract, checked
for its shape only: reading its values on the card would synchronise
every launch. Keeping ``gid`` constant within each tile is the caller's
job; the pool meets it by admitting whole groups. Kept here, not in
``serve/``, so that ``ops/`` never depends on ``serve/``.
"""

from __future__ import annotations

#: lanes per admission group: per-lane constants are uniform within every
#: aligned tile of this many lanes
LANES_GROUP = 16


def check_lanes_gid(arr, gid, who: str) -> None:
    """Validate the tile-uniform ``gid`` contract for a lanes entry: one
    group id per lane, lanes in whole 16-lane admission groups. ``arr``
    is the entry's first per-lane operand, flat ``(B, ...)``."""
    if gid.dim() != 1 or gid.shape[0] != arr.shape[0]:
        raise ValueError(
            f"{who}: gid must be (lanes,) matching the leading lane "
            f"axis, got gid {tuple(gid.shape)} for operand "
            f"{tuple(arr.shape)}")
    if arr.shape[0] % LANES_GROUP:
        raise ValueError(
            f"{who}: lane batch {arr.shape[0]} is not a multiple of "
            f"the {LANES_GROUP}-lane admission group")


def lane_tiles(t, lead: int):
    """A per-lane operand as ``(B/16, 16, ...)`` tiles: ``t`` has its
    lanes flat, ``(B, ...)`` (``lead == 1``), or already tiled,
    ``(B/16, 16, ...)`` (``lead == 2``; the pool's own layout, where a
    constant may be a 16-lane broadcast of one row per tile)."""
    if lead == 2:
        return t
    return t.reshape(t.shape[0] // LANES_GROUP, LANES_GROUP, *t.shape[1:])


def lead_dims(x, p_dims: int, who: str) -> int:
    """1 when the per-lane operand ``x`` (``p_dims`` trailing dims per
    lane) has its lanes flat, 2 when they come as ``(B/16, 16)`` tiles."""
    lead = x.dim() - p_dims
    if lead == 2 and x.shape[1] != LANES_GROUP:
        raise ValueError(
            f"{who}: tiled lanes must be (B/{LANES_GROUP}, {LANES_GROUP}, "
            f"...), got {tuple(x.shape)}")
    if lead not in (1, 2):
        raise ValueError(f"{who}: lanes must be (B, ...) or "
                         f"(B/{LANES_GROUP}, {LANES_GROUP}, ...), got "
                         f"{tuple(x.shape)}")
    return lead


def flat_lanes(t, lead: int):
    """The lane axes of a per-lane operand folded to one, ``(B, ...)``."""
    return t if lead == 1 else t.reshape(-1, *t.shape[2:])
