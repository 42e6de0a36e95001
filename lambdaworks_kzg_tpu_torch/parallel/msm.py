"""The multi-device Pippenger MSM (the JAX package's `parallel/msm.py`).

The port's MSM is fixed-base (`ops/msm.py`): member (w, i) = [2^(c w)] P_i
sits at row w N + i of a table, and the window weights are in the table,
so one MSM over a block of members is one point, not window sums. A
shard of the ``points`` mesh axis is a block of members with its own
table on its own device:

  shard="points"   device p takes points [p N/P, (p+1) N/P) of every
                   window; its table is built on that device from its
                   slice of the basis, each entry equal to the full
                   table's;
  shard="windows"  device p takes windows [p wd, (p+1) wd) of all N
                   points, wd = ceil(W / P): rows [p wd N, (p+1) wd N) of
                   the full table, padded past window W with invalid rows
                   that take digit 0, as JAX pads its digits;
  shard="auto"     points when a shard would hold at least 2^14 points,
                   else windows (JAX's rule: below that, the buckets' load
                   skew makes point shards pay).

Every shard runs the single-device path (`msm.msm_fixedbase_digits`:
one sort, one g1_bucket_accumulate and one g1_bucket_reduce launch on a
card), all of them queued before anything waits. A row's partials are
copied to its first device (`mesh.to_device`, ordered by events) and
folded there by complete adds, halving as JAX's fold does
(`_tree_fold_points`): `dispatch.fold`, one g1_fold launch on a card for
all the levels. The batch step splits the blobs over the ``data`` axis too,
padded with zero blobs to a multiple of its size; the rows' sums are
gathered on the mesh's lead device and the padding dropped. One transfer
then brings the results to the host.

Tables are cut per (device, shard), and a device that holds several
shards (a logical mesh) builds one table over all of them: no device
builds twice.

On a mesh across processes (`parallel/distributed.py`) a process builds
the tables of its own cells only and runs only their shards; each of
its rows' partials is folded as above, a row it has no cell in is
infinity, and one all_gather brings every process's [3, L, B] to every
process, where they are folded in rank order (one more `dispatch.fold`):
every process returns the same points.
"""

import torch

from ..constants import num_windows
from ..ops import dispatch, g1_ops, msm as msm1
from ..ops.g1_ops import L
from ..ops.msm import GROUPS
from . import distributed
from .mesh import to_device

# Below ~2^14 points per shard the Pippenger bucket loads are small enough
# that their max/mean skew makes point sharding pay; window sharding has no
# such term (JAX's measurement), so "auto" switches on shard size.
_POINTS_SHARD_MIN = 1 << 14


def resolve_shard(mesh, n: int, shard: str) -> str:
    """"points" or "windows" for an MSM of n points on this mesh."""
    if shard == "auto":
        return "points" if n // mesh.shape["points"] >= _POINTS_SHARD_MIN else "windows"
    if shard not in ("points", "windows"):
        raise ValueError(f"shard must be 'points', 'windows' or 'auto', got {shard!r}")
    return shard


def _cut(table16: torch.Tensor, valid: torch.Tensor, windows: int, lo: int, hi: int):
    """Members [lo, hi) of every window of a public table [2, L, windows n]
    and its valid mask -> ([2, L, windows (hi - lo)], valid)."""
    n = valid.shape[0] // windows
    table = table16.reshape(2, L, windows, n)[..., lo:hi].reshape(2, L, -1)
    return table, valid.reshape(windows, n)[:, lo:hi].reshape(-1)


class ShardedBasis:
    """One basis's fixed-base tables over a mesh's ``points`` axis, on the
    devices of the first `rows` rows of the ``data`` axis (all rows by
    default), kept per (device, shard) in the device's table layout.

    points: [2, L, N] public affine Montgomery limbs with valid bool[N],
    on any device; fixedbase: the full table (public [2, L, W N], valid)
    to cut the shards from instead of building them."""

    def __init__(self, mesh, points, valid, c: int, shard: str = "points", rows=None,
                 fixedbase=None):
        self.mesh, self.c = mesh, c
        self.n = valid.shape[0]
        self.shard = resolve_shard(mesh, self.n, shard)
        self.rows = mesh.shape["data"] if rows is None else rows
        p_axis, w = mesh.shape["points"], num_windows(c)
        if self.shard == "points":
            if self.n % p_axis:
                raise ValueError(f"{self.n} points do not split over a points axis of {p_axis}")
            self.width = self.n // p_axis  # points a shard
        else:
            self.width = -(-w // p_axis)  # windows a shard
        held = {}  # device -> the shards it holds, in order
        for r, row in enumerate(mesh.devices[: self.rows]):
            for p, dev in enumerate(row):
                if mesh.owns(r, p) and p not in held.setdefault(dev, []):
                    held[dev].append(p)
        self.tables = {}
        for dev, shards in held.items():
            for p, table in zip(shards, self._build(dev, shards, points, valid, fixedbase)):
                self.tables[(dev, p)] = table

    def _build(self, dev, shards, points, valid, fixedbase) -> list:
        """The (table, valid) of each of `shards` on dev, in its table layout."""
        w, c = num_windows(self.c), self.c
        if self.shard == "points":
            spans = [(p * self.width, (p + 1) * self.width) for p in shards]
            if fixedbase is None:  # one build over the points of every shard dev holds
                idx = torch.cat([torch.arange(lo, hi) for lo, hi in spans])
                built = dispatch.fixedbase_table(
                    to_device(points.index_select(-1, idx.to(points.device)), dev),
                    to_device(valid.index_select(0, idx.to(valid.device)), dev), c)
                if len(shards) == 1:
                    return [built]
                fixedbase = (dispatch.from_table_layout(built[0]), built[1])
                spans = [(k * self.width, (k + 1) * self.width) for k in range(len(shards))]
            cuts = [_cut(*fixedbase, w, lo, hi) for lo, hi in spans]
        else:
            if fixedbase is None:  # each device builds the full table once
                built, built_valid = dispatch.fixedbase_table(to_device(points, dev),
                                                              to_device(valid, dev), c)
                fixedbase = (dispatch.from_table_layout(built), built_valid)
            table16, table_valid = fixedbase
            pad = (self.width * self.mesh.shape["points"] - w) * self.n
            if pad:  # the windows past W: zero rows, never valid
                table16 = torch.cat([table16, table16.new_zeros(2, L, pad)], dim=-1)
                table_valid = torch.cat([table_valid, table_valid.new_zeros(pad)])
            rows = self.width * self.n
            cuts = [(table16[..., p * rows:(p + 1) * rows], table_valid[p * rows:(p + 1) * rows])
                    for p in shards]
        return [(dispatch.to_table_layout(to_device(t, dev)), to_device(v, dev)) for t, v in cuts]

    def public(self, device, p: int):
        """Shard p's table on device in the public layout, and its valid."""
        table, valid = self.tables[(device, p)]
        return dispatch.from_table_layout(table), valid

    def _digits(self, scalars: torch.Tensor, p: int) -> torch.Tensor:
        """[B, 16, N] (or shard p's points [B, 16, N/P]) -> shard p's
        digits [B, members], one for each row of its table."""
        if self.shard == "points":
            return msm1.fixedbase_digits(scalars, self.c)
        digits = msm1.window_digits(scalars, self.c)  # [B, W, N]
        w = digits.shape[-2]
        lo, hi = p * self.width, min((p + 1) * self.width, w)
        mine = digits[..., lo:hi, :]
        if hi - lo < self.width:  # padding windows take digit 0
            mine = torch.cat([mine, mine.new_zeros(mine.shape[0], self.width - (hi - lo), self.n)], -2)
        return mine.flatten(-2)

    def msm(self, scalars: torch.Tensor, rows=None) -> torch.Tensor:
        """[B, 16, N] plain Fr limbs (any device) -> Jacobian [3, L, B] in
        the public layout on the mesh's lead device: the blobs padded with
        zero blobs to a multiple of `rows` (default: every row the tables
        cover) and split over those rows of the data axis, each row's
        blobs over the points axis."""
        rows = self.rows if rows is None else rows
        if not 1 <= rows <= self.rows:
            raise ValueError(f"rows must be in [1, {self.rows}], got {rows}")
        b = scalars.shape[0]
        pad = (-b) % rows
        if pad:
            scalars = torch.cat([scalars, scalars.new_zeros((pad,) + scalars.shape[1:])])
        per_row = scalars.shape[0] // rows
        partials = []  # every shard queued before any fold
        for r in range(rows):
            blobs = scalars[r * per_row:(r + 1) * per_row]
            row = []
            for p, dev in enumerate(self.mesh.devices[r]):
                if not self.mesh.owns(r, p):
                    continue
                mine = blobs[..., p * self.width:(p + 1) * self.width] if self.shard == "points" else blobs
                table, valid = self.tables[(dev, p)]
                digits = self._digits(to_device(mine, dev), p)
                row.append((dev, msm1.msm_fixedbase_digits(table, valid, digits, self.c, GROUPS)))
            partials.append(row)
        lead = self.mesh.lead
        sums = []
        for row in partials:
            if not row:  # every cell of the row is another process's
                sums.append(g1_ops.infinity_like((), per_row, lead))
                continue
            home = row[0][0]
            parts = torch.stack([to_device(dispatch.from_op_layout(pt), home) for _, pt in row])
            sums.append(to_device(dispatch.fold(parts), lead))
        out = torch.cat(sums, dim=-1)
        if self.mesh.ranks is not None:
            out = dispatch.fold(distributed.all_gather_points(out))
        return out[..., :b]


def make_msm_step(mesh, c: int = 8, shard: str = "points", scalar_bits: int = 255):
    """The single-MSM step: step(points [2, L, N], valid [N], scalars
    [16, N]) -> Jacobian [3, L, 1] (public layout) on the mesh's lead
    device. The scalars are checked against 2^scalar_bits before any shard
    runs; the tables are built for the call on row 0 of the data axis."""

    def step(points, valid, scalars):
        msm1.check_scalar_bits(scalars, scalar_bits)
        basis = ShardedBasis(mesh, points, valid, c, shard, rows=1)
        return basis.msm(scalars[None])

    return step


def sharded_msm_device(mesh, points, valid, scalars, c: int = 8, shard: str = "auto",
                       scalar_bits: int = 255) -> torch.Tensor:
    """sum_i k_i P_i sharded over the points axis -> Jacobian [3, L, 1] on
    the lead device; an invalid point counts as infinity."""
    return make_msm_step(mesh, c, shard, scalar_bits)(points, valid, scalars)


def sharded_msm(mesh, points, valid, scalars, c: int = 8, shard: str = "auto",
                scalar_bits: int = 255):
    """Multi-device MSM -> host Jacobian point (Python ints)."""
    return g1_ops.points_to_host(
        sharded_msm_device(mesh, points, valid, scalars, c, shard, scalar_bits))[0]


def make_batch_msm_step(mesh, c: int = 8):
    """The batch step: step(points [2, L, N], valid [N], scalars [B, 16, N])
    -> Jacobian [3, L, B] (public layout) on the lead device; the blobs
    over the data axis (padded to a multiple of its size), the points over
    the points axis (N divisible by its size), tables built for the call."""

    def step(points, valid, scalars_batch):
        return ShardedBasis(mesh, points, valid, c, "points").msm(scalars_batch)

    return step


def batch_msm(mesh, points, valid, scalars_batch, c: int = 8) -> list:
    """Multi-device batch MSM -> list of B host Jacobian points."""
    return g1_ops.points_to_host(make_batch_msm_step(mesh, c)(points, valid, scalars_batch))
