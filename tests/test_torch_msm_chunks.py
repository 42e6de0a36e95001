"""The balanced schedule of the MSM kernels at N = 32 on the dev setup:
`g1_ops.accumulate_chunks`, `merge_schedule` / `merge_chunks` and
`reduce_chunks`, the plain versions of g1_bucket_accumulate and
g1_bucket_reduce (csrc/msm.cu), which cut each blob's sorted members into
chunks of at most L members of one bucket and merge each bucket's chunk
partials pairwise before the fold.

- a Python-int rendering of the chunk plan (each chunk's bucket, first
  member and count) and of the merge tree equals what the plain versions
  run, at c = 3, 4, 6 on one and three blobs: every member of buckets
  j >= 1 lies in exactly one chunk, no chunk holds more than L, and the
  kernel's merge (a level at a time, each level's adds counted per bucket
  and dealt round-robin to the blob's workers) makes the same adds, in
  ceil(log2 chunks) levels, none of its workers taking more than its
  share of each level;
- the chunked accumulation with its merge equals the JAX package's
  schedule (`g1_ops.bucket_accumulate`, summed over its lane groups) per
  bucket, and the chunked reduce equals `g1_ops.bucket_reduce`, in affine
  form: on random digits, on every member in one bucket, on a basis of
  four points tiled (equal points meet inside a chunk and across the
  merge) and on a basis of points beside their negations (P and -P
  cancel inside a chunk and across the merge);
- the MSM through the new schedule equals the JAX package's
  `msm_fixedbase` (fed the same table) and the host oracle in affine
  form, for a batch of three blobs;
- the kernel wrappers refuse CPU tensors, chunk lengths and windows
  their kernels do not take, and partials of the wrong shape.
The kernels themselves are held against these plain versions on the
card in tests/test_torch_cuda.py and chip_smoke.py."""

import collections
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_kzg_tpu.constants import R
from lambdaworks_kzg_tpu.host import curve as HC
from lambdaworks_kzg_tpu.models import srs
from lambdaworks_kzg_tpu.ops import g1_ops as JG, msm as JM
from lambdaworks_kzg_tpu_torch.constants import num_windows
from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb, msm
from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

N = 32
GROUPS = 4  # the JAX schedule's lane groups, as tests/test_torch_msm.py runs it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def basis():
    setup = srs.create_dev_setup(N, secret=0xFB)
    points, valid = JG.make_points_host(list(setup.g1_lagrange_brp))
    return list(setup.g1_lagrange_brp), torch.from_numpy(np.asarray(points).astype(np.int64))


@pytest.fixture(scope="module")
def tables(basis):
    """(c, basis transform) -> the plain fixed-base table, built once."""
    _, points = basis
    built = {}

    def get(c, transform=None):
        if (c, transform) not in built:
            pts = points if transform is None else transform(points)
            built[(c, transform)] = msm.build_fixedbase_tables(
                pts, torch.ones(N, dtype=torch.bool), c, ops=g1_ops)
        return built[(c, transform)]
    return get


def _random_members(table_valid, c, n_blobs, seed):
    rng = random.Random(seed)
    scalars = torch.stack([msm.scalars_to_tensor([rng.randrange(R) for _ in range(N)])
                           for _ in range(n_blobs)])
    digits = msm.fixedbase_digits(scalars, c)
    return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), c)


# -- the plan and the merge tree in Python ints ---------------------------------


def _render_plan(bstart, n_members, c, chunk):
    """[(bucket, first member, count)] of one blob in slot order."""
    nb, lanes = 1 << c, []
    for j in range(1, nb):
        end = bstart[j + 1] if j + 1 < nb else n_members
        for start in range(bstart[j], end, chunk):
            lanes.append((j, start, min(chunk, end - start)))
    return lanes


def _render_tree(lanes):
    """{level: sorted [(left slot, right slot)]} of one blob: each
    bucket's slots halved level by level, pairs of neighbours, an odd
    last node waiting."""
    tree, slots_of = {}, {}
    for s, (j, _, _) in enumerate(lanes):
        slots_of.setdefault(j, []).append(s)
    for nodes in slots_of.values():
        level = 1
        while len(nodes) > 1:
            tree.setdefault(level, []).extend(
                (nodes[k], nodes[k + 1]) for k in range(0, len(nodes) - 1, 2))
            nodes, level = nodes[::2], level + 1
    return {lv: sorted(pairs) for lv, pairs in tree.items()}


def _render_levels(lanes, c, workers):
    """The kernel's merge: level l (half = 2^(l-1)) counts each bucket's
    adds, n > half ? (n - half - 1) // (2 half) + 1 : 0 for n chunks, and
    add k of the level (in bucket order) goes to worker k mod `workers`:
    bucket j with its first add at Q_j adds slot P_j + i 2 half + half
    into P_j + i 2 half for i = k - Q_j -> ({level: sorted adds}, {worker:
    adds it makes})."""
    first, count = [0] * (1 << c), [0] * (1 << c)
    for s, (j, _, _) in enumerate(lanes):
        if not count[j]:
            first[j] = s
        count[j] += 1
    levels, load, half, level = {}, {}, 1, 1
    while True:
        per = [(n - half - 1) // (2 * half) + 1 if n > half else 0 for n in count]
        if not sum(per):
            return {lv: sorted(pairs) for lv, pairs in levels.items()}, load
        q = [sum(per[:j]) for j in range(len(per))]
        for k in range(sum(per)):
            j = max(jj for jj in range(len(q)) if q[jj] <= k)
            left = first[j] + (k - q[j]) * 2 * half
            levels.setdefault(level, []).append((left, left + half))
            load[k % workers] = load.get(k % workers, 0) + 1
        half, level = 2 * half, level + 1


@pytest.mark.parametrize("c,chunk", [(3, 5), (4, 3), (6, 2)])
@pytest.mark.parametrize("n_blobs", [1, 3])
def test_chunk_plan_and_merge_tree_match_python_rendering(c, chunk, n_blobs):
    valid = torch.ones(num_windows(c) * N, dtype=torch.bool)
    valid[5::7] = False  # invalid members go to bucket 0, which has no chunk
    order, bstart = _random_members(valid, c, n_blobs, seed=c + n_blobs)
    n_members = order.shape[1]
    slots = g1_ops.chunk_slots(n_members, c, chunk)
    bucket, start, count = g1_ops.chunk_lanes(bstart, n_members, c, chunk)
    assert tuple(count.shape) == (n_blobs, slots) and slots % g1_ops.SLOT_ALIGN == 0
    levels = g1_ops.merge_schedule(bstart, n_members, c, chunk)
    for b in range(n_blobs):
        bs = [int(x) for x in bstart[b]]
        lanes = _render_plan(bs, n_members, c, chunk)
        assert len(lanes) <= -(-n_members // chunk) + (1 << c) <= slots
        got = [(int(j), int(s), int(k)) for j, s, k in zip(bucket[b], start[b], count[b]) if k]
        assert got == lanes
        assert int(count[b, len(lanes):].abs().sum()) == 0
        assert all(0 < k <= chunk for _, _, k in lanes)
        covered = sorted(m for _, s, k in lanes for m in range(s, s + k))
        assert covered == list(range(bs[1], n_members))  # every member of j >= 1 once
        tree = {lv + 1: sorted((int(l) - b * slots, int(r) - b * slots)
                               for l, r in zip(*levels[lv]) if b * slots <= int(l) < (b + 1) * slots)
                for lv in range(len(levels))}
        tree = {lv: pairs for lv, pairs in tree.items() if pairs}
        assert tree == _render_tree(lanes)
        workers = 24  # a blob's workers at any count share each level's adds evenly
        rendered, load = _render_levels(lanes, c, workers)
        assert rendered == tree
        depth = max((n - 1).bit_length() for n in collections.Counter(j for j, _, _ in lanes).values())
        assert len(tree) == depth  # levels: ceil(log2 chunks) of the largest bucket
        per_level = [len(pairs) for pairs in tree.values()]
        assert max(load.values()) <= sum(-(-n // workers) for n in per_level)


# -- the new schedule against the JAX package's, in affine form -----------------


def _same(p, q):
    return HC.points_eq(HC.FP_OPS, p, q)


def _tiled(points):
    """Four basis points repeated over all N lanes."""
    return points[:, :, torch.arange(N) % 4].contiguous()


def _with_negations(points):
    """P_0, -P_0, P_1, -P_1, ..."""
    half = points[:, :, : N // 2]
    neg = torch.stack([half[0], FP.neg(half[1])])
    return torch.stack([half, neg], dim=-1).reshape(2, 24, N).contiguous()


CASES = {
    # name: (c, chunk, basis transform, digits: "random", "one bucket" (the
    # first 256 members in bucket 1, the rest in bucket 0) or "equal scalars")
    "random digits": (4, 3, None, "random"),
    "one bucket": (4, 5, None, "one bucket"),
    "tiled equal points": (3, 4, _tiled, "equal scalars"),
    "P and -P": (4, 3, _with_negations, "equal scalars"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_schedule_matches_jax_schedule_in_affine_form(tables, case):
    c, chunk, transform, kind = CASES[case]
    table, table_valid = tables(c, transform)
    n_blobs, n_members = 2, table.shape[-1]
    if kind == "random":
        order, bstart = _random_members(table_valid, c, n_blobs, seed=7)
    else:
        digits = (torch.arange(n_members) < 256).long().expand(n_blobs, -1).contiguous()
        if kind == "equal scalars":  # one scalar on every lane: its digits by window
            s = random.Random(8).randrange(R)
            w = msm.window_digits(msm.scalars_to_tensor([s]), c)[:, 0]
            digits = w.repeat_interleave(N)[None].expand(n_blobs, -1).contiguous()
        order, bstart = msm.sort_members(digits, c)
    partials = g1_ops.accumulate_chunks(table, order, bstart, c, chunk)
    assert tuple(partials.shape) == (3, 24, n_blobs * g1_ops.chunk_slots(n_members, c, chunk))
    buckets = g1_ops.merge_chunks(partials, bstart, c, chunk, n_members)
    old = g1_ops.bucket_accumulate(table, order, bstart, c, GROUPS)
    nb = 1 << c
    want = g1_ops.points_to_host(old)
    got = g1_ops.points_to_host(buckets)
    for b in range(n_blobs):
        for j in range(1, nb):
            acc = want[b * GROUPS * nb + j]
            for g in range(1, GROUPS):
                acc = HC.point_add(HC.FP_OPS, acc, want[(b * GROUPS + g) * nb + j])
            assert _same(got[b * nb + j], acc), (case, b, j)
    if kind != "random":
        assert len(g1_ops.merge_schedule(bstart, n_members, c, chunk)) >= 3
    sums = g1_ops.points_to_host(g1_ops.reduce_chunks(partials, bstart, c, chunk, n_members))
    want_sums = g1_ops.points_to_host(g1_ops.bucket_reduce(old, c, GROUPS))
    assert all(_same(p, q) for p, q in zip(sums, want_sums, strict=True))
    assert torch.equal(partials, g1_ops.accumulate_chunks(table, order, bstart, c, chunk))


def test_msm_through_chunks_matches_jax_and_host_oracle(basis, tables):
    pts_aff, _ = basis
    c, chunk = 4, 3
    table, table_valid = tables(c)
    rng = random.Random(11)
    blobs = [[rng.randrange(R) for _ in range(N)] for _ in range(3)]
    blobs[1][:5] = [0, 1, R - 1, 0, 2]
    got = msm.msm_fixedbase(table, table_valid, torch.stack([msm.scalars_to_tensor(s) for s in blobs]),
                            c=c, chunk=chunk)
    jtable = jnp.asarray(table.numpy().astype(np.uint32))
    for pt, s in zip(got, blobs):
        assert _same(pt, HC.g1_msm(s, pts_aff))
        jax_pt = JM.msm_fixedbase(jtable, jnp.asarray(table_valid.numpy()), JM.scalars_to_device(s),
                                  c=c, groups=GROUPS)
        assert _same(pt, jax_pt)


def test_chunk_kernel_wrappers_refuse_what_they_do_not_take(tables):
    c, chunk = 4, 3
    table, table_valid = tables(c)
    order, bstart = _random_members(table_valid, c, 1, seed=3)
    n_members = order.shape[1]
    rows = lb.to_u32_layout(table).permute(2, 0, 1).contiguous()
    partials = torch.zeros((g1_ops.chunk_slots(n_members, c, chunk), 3, 12), dtype=torch.int32)
    kernels.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bucket_accumulate(rows, order, bstart, c, chunk)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bucket_reduce(partials, bstart, c, chunk, n_members)
    with pytest.raises(ValueError, match="chunk"):
        kernels.bucket_accumulate(rows, order, bstart, c, 0)
    with pytest.raises(ValueError, match="chunk"):
        kernels.bucket_reduce(partials, bstart, c, kernels.MAX_CHUNK + 1, n_members)
    with pytest.raises(ValueError, match="window bits"):
        kernels.bucket_reduce(partials, bstart, 13, chunk, n_members)
    with pytest.raises(ValueError, match="shape"):
        kernels.bucket_reduce(partials[1:], bstart, c, chunk, n_members)
    assert [k.launches for k in kernels.ALL] == [0] * len(kernels.ALL)
