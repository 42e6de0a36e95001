"""The multi-device Pippenger MSM (the JAX package's `parallel/msm.py`).

Two MSMs run over a mesh's ``points`` axis, each on the single-device
kernels (`ops/msm.py`: one sort, one g1_bucket_accumulate and one
g1_bucket_reduce launch a shard on a card), every shard queued before
anything waits.

The generic MSM (`make_msm_step`, `sharded_msm`, `make_batch_msm_step`,
`batch_msm`) is JAX's windowed one, `_local_window_sums` and its steps:
a shard computes window sums (`msm.window_sums`, one blob a window over
its points) and one combine on the lead device
(`dispatch.combine_windows`, one g1_window_combine launch) turns them
into points. No table is built.

  shard="points"   device p takes points [p N/P, (p+1) N/P) of every
                   window; a row's P window-sum arrays are copied to its
                   first device (`mesh.to_device`, ordered by events) and
                   folded there by complete adds, halving as JAX's fold
                   does (`_tree_fold_points`): `dispatch.fold`, one
                   g1_fold launch on a card for all the levels;
  shard="windows"  device p takes windows [p wd, (p+1) wd) of all N
                   points, wd = ceil(W / P); the W sums are gathered in
                   window order, with no fold (a device past window W
                   runs nothing);
  shard="auto"     points when a shard would hold at least 2^14 points,
                   else windows (JAX's rule: below that, the buckets' load
                   skew makes point shards pay).

The batch step splits the MSMs over the ``data`` axis too, padded with
zero-scalar MSMs to a multiple of its size, each row's over the points
axis; the rows' window sums are gathered on the lead device, combined
in one launch and the padding dropped. One transfer then brings the
results to the host.

The fixed-base MSM over a setup's basis (`ShardedBasis`, the commit and
proof path of a backend on a mesh) keeps one table per (device, shard)
of the points axis, built once per setup: member (w, i) = [2^(c w)] P_i
sits at row w N + i, the window weights are in the table, so a shard's
result is one point and there is no combine. A device that holds several
shards (a logical mesh) builds one table over all of them.

On a mesh across processes (`parallel/distributed.py`) a process runs
its own cells only: a row it has no cell in, or a window it does not
own, is infinity, and one all_gather brings every process's window sums
(or points) to every process, where they are folded in rank order (one
more `dispatch.fold`) before the combine: every process returns the same
points.
"""

import torch

from ..constants import num_windows
from ..ops import dispatch, g1_ops, msm as msm1
from ..ops.g1_ops import L
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


def _point_width(mesh, n: int) -> int:
    """Points a shard of the points axis takes; ValueError unless n splits."""
    p_axis = mesh.shape["points"]
    if n % p_axis:
        raise ValueError(f"{n} points do not split over a points axis of {p_axis}")
    return n // p_axis


def _owned(mesh, r: int) -> list:
    """(p, device) of row r's cells that this process runs."""
    return [(p, dev) for p, dev in enumerate(mesh.devices[r]) if mesh.owns(r, p)]


def _pad_rows(scalars: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, 16, N] padded with zero-scalar MSMs to a multiple of rows."""
    pad = (-scalars.shape[0]) % rows
    if pad:
        scalars = torch.cat([scalars, scalars.new_zeros((pad,) + scalars.shape[1:])])
    return scalars


def _gather(mesh, partials: list, lanes: int) -> torch.Tensor:
    """Each row's (device, [3, *, lanes] op-layout partial) list -> the
    rows' folds side by side, [3, L, rows lanes] public on the lead
    device: a row's partials folded on its first device (one
    `dispatch.fold`), a row with no cell of this process infinity; across
    processes every process's rows gathered and folded in rank order."""
    lead = mesh.lead
    sums = []
    for row in partials:
        if not row:  # every cell of the row is another process's
            sums.append(g1_ops.infinity_like((), lanes, lead))
            continue
        home = row[0][0]
        parts = torch.stack([to_device(dispatch.from_op_layout(pt), home) for _, pt in row])
        sums.append(to_device(dispatch.fold(parts), lead))
    out = torch.cat(sums, dim=-1)
    if mesh.ranks is not None:
        out = dispatch.fold(distributed.all_gather_points(out))
    return out


class ShardedBasis:
    """One basis's fixed-base tables over a mesh's ``points`` axis, on the
    devices of the first `rows` rows of the ``data`` axis (all rows by
    default), kept per (device, shard) in the device's table layout:
    shard p holds points [p N/P, (p+1) N/P) of every window.

    points: [2, L, N] public affine Montgomery limbs with valid bool[N],
    on any device; fixedbase: the full table (public [2, L, W N], valid)
    to cut the shards from instead of building them."""

    def __init__(self, mesh, points, valid, c: int, rows=None, fixedbase=None):
        self.mesh, self.c = mesh, c
        self.n = valid.shape[0]
        self.rows = mesh.shape["data"] if rows is None else rows
        self.width = _point_width(mesh, self.n)  # points a shard
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
        w = num_windows(self.c)
        spans = [(p * self.width, (p + 1) * self.width) for p in shards]
        if fixedbase is None:  # one build over the points of every shard dev holds
            idx = torch.cat([torch.arange(lo, hi) for lo, hi in spans])
            built = dispatch.fixedbase_table(
                to_device(points.index_select(-1, idx.to(points.device)), dev),
                to_device(valid.index_select(0, idx.to(valid.device)), dev), self.c)
            if len(shards) == 1:
                return [built]
            fixedbase = (dispatch.from_table_layout(built[0]), built[1])
            spans = [(k * self.width, (k + 1) * self.width) for k in range(len(shards))]
        cuts = [_cut(*fixedbase, w, lo, hi) for lo, hi in spans]
        return [(dispatch.to_table_layout(to_device(t, dev)), to_device(v, dev)) for t, v in cuts]

    def public(self, device, p: int):
        """Shard p's table on device in the public layout, and its valid."""
        table, valid = self.tables[(device, p)]
        return dispatch.from_table_layout(table), valid

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
        scalars = _pad_rows(scalars, rows)
        per_row = scalars.shape[0] // rows
        partials = []  # every shard queued before any fold
        for r in range(rows):
            blobs = scalars[r * per_row:(r + 1) * per_row]
            row = []
            for p, dev in _owned(self.mesh, r):
                table, valid = self.tables[(dev, p)]
                mine = to_device(blobs[..., p * self.width:(p + 1) * self.width], dev)
                digits = msm1.fixedbase_digits(mine, self.c)
                row.append((dev, msm1.msm_fixedbase_digits(table, valid, digits, self.c)))
            partials.append(row)
        return _gather(self.mesh, partials, per_row)[..., :b]


def _window_sums(mesh, points, valid, scalars: torch.Tensor, c: int, shard: str, scalar_bits: int,
                 rows: int) -> torch.Tensor:
    """The window sums of B MSMs over one point set -> [3, L, B' W]
    public on the lead device (B' = B padded to a multiple of rows, MSM
    b's window w at b W + w): the MSMs split over `rows` rows of the data
    axis, each row's over the points axis by points (a row's shards
    folded) or by windows (placed in window order)."""
    w = num_windows(c, scalar_bits)
    width = _point_width(mesh, valid.shape[0]) if shard == "points" else -(-w // mesh.shape["points"])
    scalars = _pad_rows(scalars, rows)
    per_row = scalars.shape[0] // rows
    partials = []  # every shard queued before any fold
    for r in range(rows):
        blobs = scalars[r * per_row:(r + 1) * per_row]
        row = []
        for p, dev in _owned(mesh, r):
            lo, hi = p * width, (p + 1) * width
            if shard == "points":
                digits = msm1.window_digits(to_device(blobs[..., lo:hi], dev), c, scalar_bits)
                sums = msm1.window_sums(to_device(points[..., lo:hi], dev),
                                        to_device(valid[lo:hi], dev), digits, c)
                row.append((dev, sums))
                continue
            hi = min(hi, w)
            if lo >= hi:  # past window W
                continue
            digits = msm1.window_digits(to_device(blobs, dev), c, scalar_bits)[..., lo:hi, :]
            sums = msm1.window_sums(to_device(points, dev), to_device(valid, dev), digits, c)
            row.append((dev, sums.reshape(sums.shape[:-1] + (per_row, hi - lo)), lo, hi))
        if shard == "windows" and row:  # the row's windows in order, infinity where not owned
            home, first = row[0][:2]
            full = first.new_zeros(first.shape[:-1] + (w,), device=home)
            for _, sums, lo, hi in row:
                full[..., lo:hi] = to_device(sums, home)
            row = [(home, full.flatten(-2))]
        partials.append(row)
    return _gather(mesh, partials, per_row * w)


def _generic_msm(mesh, points, valid, scalars: torch.Tensor, c: int, shard: str, scalar_bits: int,
                 rows: int) -> torch.Tensor:
    """[B, 16, N] scalars -> Jacobian [3, L, B] public on the lead device:
    the window sums (`_window_sums`), then one combine of them all
    on the lead device."""
    msm1.check_scalar_bits(scalars, scalar_bits)
    shard = resolve_shard(mesh, valid.shape[0], shard)
    sums = _window_sums(mesh, points, valid, scalars, c, shard, scalar_bits, rows)
    w = num_windows(c, scalar_bits)
    out = dispatch.combine_windows(dispatch.to_op_layout(sums), c, w)
    return dispatch.from_op_layout(out)[..., :scalars.shape[0]]


def make_msm_step(mesh, c: int = 8, shard: str = "points", scalar_bits: int = 255):
    """The single-MSM step: step(points [2, L, N], valid [N], scalars
    [16, N]) -> Jacobian [3, L, 1] (public layout) on the mesh's lead
    device, over row 0 of the data axis. The scalars are checked against
    2^scalar_bits before any shard runs."""

    def step(points, valid, scalars):
        return _generic_msm(mesh, points, valid, scalars[None], c, shard, scalar_bits, rows=1)

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


def make_batch_msm_step(mesh, c: int = 8, scalar_bits: int = 255):
    """The batch step: step(points [2, L, N], valid [N], scalars [B, 16, N])
    -> Jacobian [3, L, B] (public layout) on the lead device; the MSMs
    over the data axis (padded to a multiple of its size), the points
    over the points axis (N divisible by its size)."""

    def step(points, valid, scalars_batch):
        return _generic_msm(mesh, points, valid, scalars_batch, c, "points", scalar_bits,
                            rows=mesh.shape["data"])

    return step


def batch_msm(mesh, points, valid, scalars_batch, c: int = 8, scalar_bits: int = 255) -> list:
    """Multi-device batch MSM -> list of B host Jacobian points."""
    return g1_ops.points_to_host(
        make_batch_msm_step(mesh, c, scalar_bits)(points, valid, scalars_batch))
