"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's jnp references, on the shapes of
``tests/test_kernels.py`` plus sorted, out-of-range and sparse ids; the
fused hop against the three-dispatch contract of
``tests/test_fused_hop.py`` built from ``repro.kernels.ref``.

Tolerance 0: the data are integer-valued float32 below 2**24, so every
sum is exact in any order.  ``semiring_matmul`` is also held on
fractional data: its plain version's fused multiply-add step against
libm's ``fmaf`` and the numpy mirror of the kernel's tile loop at
tolerance 0, and against ``jnp.dot``, which fixes no summation order, at
the stated bound.  The CUDA kernels themselves run only on a card;
``chip_smoke.py`` holds them against these plain versions there.
"""
import ctypes
import ctypes.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.coo_spmm import coo_spmm
from repro_torch.kernels.fused_hop import MAX_CHILDREN, fused_hop
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.kernels.semiring_matmul import semiring_matmul

SEG_SHAPES = [(100, 8, 16), (513, 128, 130), (64, 256, 7), (1, 8, 3)]
SPMM_SHAPES = [(200, 32, 24, 16), (1000, 130, 257, 128), (5, 8, 8, 8)]
# random: any order; sorted: grouped-CSR order (what the kernels take);
# out_of_range: sorted with ids below 0 and at/above num_segments;
# sparse: a few distinct ids, so most segments are empty
ID_MODES = ["random", "sorted", "out_of_range", "sparse"]


def _ids(rng, n: int, s: int, mode: str) -> np.ndarray:
    if mode == "random":
        return rng.integers(0, s, n)
    if mode == "sorted":
        return np.sort(rng.integers(0, s, n))
    if mode == "out_of_range":
        return np.sort(rng.integers(-3, s + 3, n))
    return np.sort(rng.choice(rng.integers(0, s, 2), n))


def _data(rng, shape) -> np.ndarray:
    return rng.integers(-50, 50, shape).astype(np.float32)


@pytest.mark.parametrize("mode", ID_MODES)
@pytest.mark.parametrize("n,d,s", SEG_SHAPES)
def test_segment_sum_matches_jax_ref(n, d, s, mode):
    rng = np.random.default_rng(n * 7 + d)
    data, ids = _data(rng, (n, d)), _ids(rng, n, s, mode)
    want = jref.segment_sum_ref(jnp.asarray(data), jnp.asarray(ids, jnp.int32), s)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("mode", ID_MODES)
@pytest.mark.parametrize("n,d,s", SEG_SHAPES)
def test_segment_reduce_matches_jax_ref(n, d, s, mode, kind):
    rng = np.random.default_rng(n * 5 + d)
    data, ids = _data(rng, (n, d)), _ids(rng, n, s, mode)
    want = jref.segment_reduce_ref(
        jnp.asarray(data), jnp.asarray(ids, jnp.int32), s, kind
    )
    got = segment_reduce(torch.from_numpy(data), torch.from_numpy(ids), s, kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["random", "sorted", "out_of_range"])
@pytest.mark.parametrize("nnz,m,k,n", SPMM_SHAPES)
def test_coo_spmm_matches_jax_ref(nnz, m, k, n, mode):
    rng = np.random.default_rng(nnz + m)
    rows = _ids(rng, nnz, m, mode)
    cols = rng.integers(0, k, nnz)
    vals = rng.integers(1, 5, nnz).astype(np.float32)
    dense = _data(rng, (k, n))
    want = jref.coo_spmm_ref(
        jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
        jnp.asarray(vals), jnp.asarray(dense), m,
    )
    got = coo_spmm(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals),
        torch.from_numpy(dense), m,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_reduce_empty_segments_hold_identity():
    data = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    ids = torch.tensor([0, 0])
    lo = segment_reduce(data, ids, 3, "min")
    hi = segment_reduce(data, ids, 3, "max")
    assert lo[0].tolist() == [1.0, 2.0] and hi[0].tolist() == [3.0, 4.0]
    assert torch.all(lo[1:] == float("inf")) and torch.all(hi[1:] == float("-inf"))


def test_empty_input_writes_identity_everywhere():
    data = torch.zeros((0, 4))
    ids = torch.zeros(0, dtype=torch.int64)
    assert torch.equal(segment_sum(data, ids, 5), torch.zeros(5, 4))
    assert torch.all(segment_reduce(data, ids, 5, "max") == float("-inf"))
    dense = torch.ones(3, 4)
    assert torch.equal(
        coo_spmm(ids, ids, torch.zeros(0), dense, 5), torch.zeros(5, 4)
    )


def test_coo_spmm_drops_out_of_range_rows_and_cols():
    rng = np.random.default_rng(3)
    rows = np.sort(rng.integers(-2, 9, 300))
    cols = rng.integers(-2, 14, 300)
    vals = rng.integers(1, 9, 300).astype(np.float32)
    dense = _data(rng, (12, 5))
    want = np.zeros((7, 5), np.float32)
    for r, c, v in zip(rows, cols, vals):
        if 0 <= r < 7 and 0 <= c < 12:
            want[r] += v * dense[c]
    got = coo_spmm(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals),
        torch.from_numpy(dense), 7,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_argument_is_written_in_full_and_returned():
    data = torch.tensor([[1.0], [2.0], [5.0]])
    ids = torch.tensor([0, 2, 2])
    out = torch.full((4, 1), 99.0)
    res = segment_sum(data, ids, 4, out=out)
    assert res is out
    assert out[:, 0].tolist() == [1.0, 0.0, 7.0, 0.0]
    seg = torch.full((3, 1), 99.0)
    assert segment_reduce(data, ids, 3, "min", out=seg) is seg
    assert seg[:, 0].tolist() == [1.0, float("inf"), 2.0]


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    data, ids = torch.ones(4, 2), torch.tensor([0, 1, 1, 3])
    segment_sum(data, ids, 4)
    segment_reduce(data, ids, 4, "min")
    coo_spmm(ids, ids, torch.ones(4), torch.ones(4, 2), 4)
    fused_hop(ids, data, [data], [ids], 4, k=2)
    semiring_matmul(data, data.T.contiguous(), "min_add")
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_other_devices_raise_instead_of_falling_back():
    meta = torch.empty((4, 2), device="meta")
    ids = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_sum(meta, ids, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        segment_reduce(meta, ids, 4, "max")
    with pytest.raises(ValueError, match="unsupported device"):
        coo_spmm(ids, ids, torch.empty(4, device="meta"), meta, 4)
    with pytest.raises(ValueError, match="different devices"):
        segment_sum(torch.ones(4, 2), ids, 4)
    with pytest.raises(ValueError, match="unknown reduction"):
        segment_reduce(torch.ones(4, 2), torch.zeros(4, dtype=torch.int64), 4, "sum")


def test_kernel_build_targets_hopper_and_keys_libraries_by_source():
    assert "arch=compute_90a,code=sm_90a" in ops.NVCC_FLAGS
    assert {p.stem for p in ops.CSRC.glob("*.cu")} == set(ops.KERNELS)
    paths = {name: ops._library_path(name) for name in ops.KERNELS}
    assert len(set(paths.values())) == len(ops.KERNELS)
    for name, path in paths.items():
        assert path.parent == ops.BUILD_DIR and path.name.startswith(name + "-")
        assert ops._library_path(name) == path  # deterministic digest


# ----------------------------------------------------------------------
# the sorted-run walk's launch plan (kernels/ops.py:walk_plan), and the
# block search and run marking of csrc/segmented_rows.cuh mirrored here
# ----------------------------------------------------------------------


def _block_lower_bound(keys, lo, hi, value, threads=ops.WALK_THREADS):
    """``segmented_rows.cuh:block_lower_bound``: each round every thread
    probes one key, and the count of probes below ``value`` narrows the
    range."""
    while hi - lo > threads:
        stride = -(-(hi - lo) // threads)
        probes = lo + np.arange(threads) * stride
        probes = probes[probes < hi]
        below = int(np.sum(keys[probes] < value))
        if below == 0:
            return lo
        lo, hi = lo + (below - 1) * stride + 1, min(hi, lo + below * stride)
    return lo + int(np.sum(keys[lo:hi] < value))


def _run_end(keys, i, e, k):
    """``segmented_rows.cuh:run_end``: gallop, then bisect."""
    last, step, probe = i, 1, i + 1
    while probe < e and keys[probe] == k:
        last, step = probe, step * 2
        probe = last + step
    lo, hi = last + 1, min(probe, e)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if keys[mid] == k else (lo, mid)
    return lo


def _walk(keys, num_rows, d, plan):
    """What each block of the walk does, block by block: returns how often
    each output element is filled with the identity (narrow walk) and
    written with a run's value, and each row's run ``[first, stop)`` as
    marked (``None`` for a row no edge opens)."""
    n, rows_per_tile, threads = len(keys), plan.rows_per_tile, ops.WALK_THREADS
    fills = np.zeros((num_rows, d), np.int64)
    writes = np.zeros((num_rows, d), np.int64)
    runs = {}
    for block in range(plan.blocks):
        tile, slab = divmod(block, plan.slabs)
        s0 = tile * rows_per_tile
        rows = min(rows_per_tile, num_rows - s0)
        assert rows > 0, "a block past the last tile"
        if plan.narrow:  # before the search: the whole tile span
            fills[s0:s0 + rows] += 1
        e0 = _block_lower_bound(keys, 0, n, s0)
        marked, e = _mark_runs(keys, e0, s0, rows, threads)
        if plan.narrow:
            # after the search's barriers, each run by the thread holding
            # its first edge, its end found by galloping
            for k, (first, _) in marked.items():
                marked[k][1] = _run_end(keys, first, e, k)
                writes[k] += 1
        else:
            c0 = slab * plan.slab
            writes[s0:s0 + rows, c0:min(d, c0 + plan.slab)] += 1
        for k, run in marked.items():
            assert runs.setdefault(k, tuple(run)) == tuple(run)
    return fills, writes, runs


def _check_plan(plan, n, num_rows, d):
    """The plan's arithmetic, without walking it."""
    assert plan.narrow == (d < ops.NARROW_WIDTH)
    assert 1 <= plan.rows_per_tile <= num_rows
    assert plan.smem_bytes == (0 if plan.narrow else 8 * plan.rows_per_tile)
    assert plan.smem_bytes <= ops.SMEM_LIMIT
    # column slabs partition [0, d); vectors of 4 never straddle two slabs
    assert plan.slabs * plan.slab >= d > (plan.slabs - 1) * plan.slab
    assert plan.slabs == 1 or (plan.slab % 4 == 0 and plan.slab <= ops.MAX_SLAB)
    assert not plan.narrow or plan.slabs == 1
    # one block per tile and slab: every output element has one block
    tiles = -(-num_rows // plan.rows_per_tile)
    assert plan.blocks == tiles * plan.slabs <= ops.MAX_BLOCKS
    # a block's share of one tile fits the kernel's 32-bit element index
    per_block = plan.rows_per_tile * (d if plan.narrow else plan.slab)
    assert per_block <= max(ops.NARROW_TILE_ELEMS if plan.narrow else
                            ops.WIDE_TILE_ELEMS, plan.slab) < 2**31


@settings(max_examples=300, deadline=None)
@given(
    n=st.integers(0, ops.MAX_EDGES),
    num_rows=st.integers(1, 2**34),
    d=st.one_of(st.integers(1, 64), st.integers(1, 2**20),
                st.sampled_from([2250, 4097, 4500])),
)
def test_walk_plan_arithmetic(n, num_rows, d):
    assume(num_rows * d <= 2**36)  # outputs up to 256 GiB; a card holds 80
    _check_plan(ops.walk_plan(n, num_rows, d), n, num_rows, d)


@pytest.mark.parametrize("n,num_rows,d,narrow,rows,slabs", [
    (500_000, 112_500_000, 1, 1, 16384, 1),  # leaf hops
    (500_000, 112_500_000, 2, 1, 8192, 1),
    (7456, 746, 2250, 0, 2, 3),  # edge chunks of the general hops
    (3728, 373, 4500, 0, 2, 5),
    (499_948, 50_000, 4500, 0, 2, 5),  # the coo_spmm hop
])
def test_walk_plan_at_main_path_shapes(n, num_rows, d, narrow, rows, slabs):
    plan = ops.walk_plan(n, num_rows, d)
    assert (plan.narrow, plan.rows_per_tile, plan.slabs) == (narrow, rows, slabs)
    _check_plan(plan, n, num_rows, d)
    if narrow:  # 4x-8x the 2,048 rows of the earlier walk's tiles
        assert plan.rows_per_tile * d == ops.NARROW_TILE_ELEMS
    else:  # a few hundred rows still fill the card's 132 SMs several times
        assert plan.blocks >= 7 * 132


def test_walk_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="at most 2147483647 edges"):
        ops.walk_plan(2**31, 10, 1)
    with pytest.raises(ValueError, match="num_rows >= 1 and d >= 1"):
        ops.walk_plan(10, 0, 1)
    with pytest.raises(ValueError, match="more than one launch has"):
        ops.walk_plan(10, 2**50, 1)
    assert ctypes.sizeof(ops.WalkPlan) == 48  # ReproWalkPlan, field for field


def _flat_split(offset: int, count: int) -> tuple[int, int, int]:
    """How the narrow walk (``segmented_rows.cuh``, ``V == 0``) writes
    ``count`` floats starting ``offset`` floats past a 16-byte boundary:
    ``(head, vectors, tail)`` — scalars up to the next boundary, 16-byte
    vectors, scalars."""
    misaligned = offset % 4
    head = 0 if misaligned == 0 else min(4 - misaligned, count)
    vectors = (count - head) // 4
    return head, vectors, count - head - 4 * vectors


@settings(max_examples=200, deadline=None)
@given(offset=st.integers(0, 2**40), count=st.integers(0, 200))
def test_flat_split_aligns_the_body(offset, count):
    head, vectors, tail = _flat_split(offset, count)
    assert head + 4 * vectors + tail == count
    assert 0 <= head < 4 and 0 <= tail < 4 and vectors >= 0
    if vectors or tail:  # everything after the head starts on 16 bytes
        assert (offset + head) % 4 == 0
    written = np.zeros(count, np.int64)
    written[:head] += 1
    for v in range(vectors):
        written[head + 4 * v: head + 4 * v + 4] += 1
    written[count - tail:] += tail > 0
    assert np.all(written == 1)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(
    data=st.data(),
    d=st.sampled_from([1, 2, 3, 31, 32, 33, 1025, 2250, 4097]),
    tile_elems=st.sampled_from([1, 7, 64, None]),
)
def test_walk_marks_every_run_and_writes_every_element_once(data, d, tile_elems):
    """Block search and run marking, mirrored: every output element gets
    its value once and every row's marked run is the one a binary search
    finds.  Smaller tiles than the kernel's (``tile_elems``) make many
    tiles of few rows."""
    num_rows = data.draw(st.integers(1, 3000 if d < 32 else 40))
    n = data.draw(st.integers(0, 1500))
    lo, hi = data.draw(st.sampled_from([(0, num_rows), (-3, num_rows + 3),
                                        (num_rows, num_rows + 5)]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    keys = rng.integers(lo, max(hi, lo + 1), n)
    if n and data.draw(st.booleans()):  # one run longer than a marking batch
        keys[: min(n, 700)] = rng.integers(0, num_rows)
    keys = np.sort(keys)
    with pytest.MonkeyPatch.context() as mp:
        if tile_elems is not None:
            mp.setattr(ops, "NARROW_TILE_ELEMS", tile_elems)
            mp.setattr(ops, "WIDE_TILE_ELEMS", tile_elems)
        plan = ops.walk_plan(n, num_rows, d)
    if tile_elems is None:
        _check_plan(plan, n, num_rows, d)
    fills, writes, runs = _walk(keys, num_rows, d, plan)
    for r in range(num_rows):
        first, stop = np.searchsorted(keys, r, "left"), np.searchsorted(keys, r, "right")
        assert runs.get(r) == ((int(first), int(stop)) if stop > first else None)
        if plan.narrow:  # every row filled once; each run's row then written once
            assert np.all(fills[r] == 1) and np.all(writes[r] == int(stop > first))
        else:  # every element written once, with its value
            assert np.all(fills[r] == 0) and np.all(writes[r] == 1)


# ----------------------------------------------------------------------
# plain versions at the walk's edge cases, with out= slices
# ----------------------------------------------------------------------

# (n, d, num_segments, id_lo, id_hi): widths of the leaf hops, odd ones,
# the edge chunks' 2250 and 4500 and a slab-ragged 4097; ids out of range
EDGE_SHAPES = [
    (300, 1, 17, -4, 21), (500, 2, 50, 0, 50), (500, 3, 50, -1, 52),
    (700, 5, 61, 0, 61), (90, 2250, 13, -2, 15), (40, 4097, 5, 0, 5),
    (60, 4500, 11, 0, 11), (50, 2250, 9, 9, 20),
]


@pytest.mark.parametrize("out_rows", [None, 1, 3])
@pytest.mark.parametrize("n,d,s,id_lo,id_hi", EDGE_SHAPES)
def test_segment_kernels_plain_versions_at_walk_edge_cases(n, d, s, id_lo, id_hi, out_rows):
    rng = np.random.default_rng(n + d + s)
    data = _data(rng, (n, d))
    ids = np.sort(rng.integers(id_lo, id_hi, n))
    jdata, jids = jnp.asarray(data), jnp.asarray(ids, jnp.int32)
    tdata, tids = torch.from_numpy(data), torch.from_numpy(ids)
    for kind in ("sum", "min", "max"):
        if kind == "sum":
            want = np.asarray(jref.segment_sum_ref(jdata, jids, s))
        else:
            want = np.asarray(jref.segment_reduce_ref(jdata, jids, s, kind))
        out = None
        if out_rows is not None:  # rows [out_rows, out_rows + s) of a larger output
            buf = torch.full((s + out_rows + 2, d), 7777.0)
            out = buf[out_rows:out_rows + s]
        if kind == "sum":
            got = segment_sum(tdata, tids, s, out=out)
        else:
            got = segment_reduce(tdata, tids, s, kind, out=out)
        np.testing.assert_array_equal(got.numpy(), want)
        if out is not None:
            assert got is out
            assert torch.all(buf[:out_rows] == 7777.0) and torch.all(buf[out_rows + s:] == 7777.0)


# ----------------------------------------------------------------------
# the slab-major warp walk's launch plan (kernels/ops.py:gather_plan), and
# csrc/gathered_rows.cuh mirrored block by block, lane by lane
# ----------------------------------------------------------------------


def _check_gather_plan(plan, n, num_rows, d):
    """The plan's arithmetic, without walking it."""
    assert plan.slab >= 32 and plan.slab % 32 == 0
    # column slabs partition [0, d)
    assert plan.slabs * plan.slab >= d > (plan.slabs - 1) * plan.slab
    assert 1 <= plan.rows_per_block <= min(num_rows, ops.GATHER_MAX_ROWS)
    assert 1 <= plan.warps <= min(plan.rows_per_block, ops.GATHER_MAX_WARPS)
    assert plan.smem_bytes == 8 * plan.rows_per_block <= ops.SMEM_LIMIT
    assert plan.tiles == -(-num_rows // plan.rows_per_block)
    assert plan.blocks == plan.tiles * plan.slabs <= ops.MAX_BLOCKS
    assert plan.in_flight in ops.GATHER_IN_FLIGHT_CHOICES
    assert plan.slab_major in (0, 1)


def _block_cell(plan, block):
    """``gathered_rows.cuh``: the (tile, slab) that block ``block`` walks."""
    if plan.slab_major:
        slab, tile = divmod(block, plan.tiles)
    else:
        tile, slab = divmod(block, plan.slabs)
    return tile, slab


@settings(max_examples=300, deadline=None)
@given(
    n=st.integers(0, ops.MAX_EDGES),
    num_rows=st.integers(1, 2**34),
    d=st.one_of(st.integers(1, 300), st.integers(1, 2**20),
                st.sampled_from([2250, 4097, 4500])),
)
def test_gather_plan_arithmetic(n, num_rows, d):
    assume(num_rows * d <= 2**36)
    plan = ops.gather_plan(n, num_rows, d)
    _check_gather_plan(plan, n, num_rows, d)
    assert plan.slab_major == 1
    # the slab is the slow dimension: blocks [j * tiles, (j + 1) * tiles)
    # walk slab j, tile by tile
    for block in (0, plan.tiles - 1, plan.tiles, plan.blocks - 1):
        if block < plan.blocks:
            assert _block_cell(plan, block) == (block % plan.tiles, block // plan.tiles)


@pytest.mark.parametrize("slab_major", [True, False])
@pytest.mark.parametrize("num_rows,d,slab,rows,warps", [
    (1, 1, 32, 1, 1), (37, 300, 128, 8, 4), (50, 4500, 128, 32, 4),
    (9, 129, 32, 16, 2), (100, 64, 256, 4, 4), (33, 2250, 64, 32, 1),
])
def test_gather_plan_covers_every_row_and_slab_once(num_rows, d, slab, rows, warps, slab_major):
    plan = ops.make_gather_plan(500, num_rows, d, slab, rows, warps, 4, slab_major)
    _check_gather_plan(plan, 500, num_rows, d)
    cover = np.zeros((num_rows, d), np.int64)
    slabs_in_order = []
    for block in range(plan.blocks):
        tile, slab_j = _block_cell(plan, block)
        s0 = tile * plan.rows_per_block
        c0 = slab_j * plan.slab
        assert s0 < num_rows and c0 < d  # no block past the output
        cover[s0:s0 + plan.rows_per_block, c0:c0 + plan.slab] += 1
        slabs_in_order.append(slab_j)
    assert np.all(cover == 1)
    if slab_major:
        assert slabs_in_order == sorted(slabs_in_order)


@pytest.mark.parametrize("n,num_rows,d,k", [
    (499_948, 50_000, 4500, 2),  # coo_spmm and the uniform / measure-weighted hops
    (499_948, 50_000, 2250, 1),  # the MIN/MAX one-child hops
])
def test_gather_plan_at_main_path_shapes(n, num_rows, d, k):
    plan = ops.gather_plan(n, num_rows, d)
    _check_gather_plan(plan, n, num_rows, d)
    assert (plan.slab, plan.slab_major) == (ops.GATHER_SLAB, 1)
    assert plan.slabs == -(-d // ops.GATHER_SLAB)
    # one slab of the gathered operand (its 50,000 rows: the child's join
    # domain) and the edge arrays every slab rereads (keys, child index,
    # k weights) stay well inside the H100's 50 MB L2
    operand_slab = num_rows * plan.slab * 4
    edges = n * (8 + 8 + 4 * k)
    assert operand_slab + edges <= 0.8 * 50 * 2**20
    # and the blocks of one slab fill the card's 132 SMs several times over
    assert plan.tiles >= 8 * 132


def test_gather_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="at most 2147483647 edges"):
        ops.gather_plan(2**31, 10, 1)
    with pytest.raises(ValueError, match="num_rows >= 1 and d >= 1"):
        ops.gather_plan(10, 1, 0)
    with pytest.raises(ValueError, match="1 to 1024 rows"):  # tiles would outgrow a block
        ops.gather_plan(10, 2**50, 1)
    with pytest.raises(ValueError, match="more than one launch has"):
        ops.make_gather_plan(10, 2**40, 1)
    with pytest.raises(ValueError, match="multiple of 32 columns"):
        ops.make_gather_plan(10, 10, 100, slab=48)
    with pytest.raises(ValueError, match="1 to 1024 rows"):
        ops.make_gather_plan(10, 10, 100, rows=0)
    with pytest.raises(ValueError, match="1 to 4 warps"):
        ops.make_gather_plan(10, 100, 100, rows=64, warps=5)
    with pytest.raises(ValueError, match="edges in flight"):
        ops.make_gather_plan(10, 10, 100, in_flight=2)
    assert ctypes.sizeof(ops.GatherPlan) == 64  # ReproGatherPlan, field for field


def test_one_child_hops_of_a_warp_width_or_more_take_the_gather_walk():
    from repro_torch.kernels.fused_hop import gathers_one_child

    assert gathers_one_child(1, ops.NARROW_WIDTH) and gathers_one_child(1, 4500)
    assert not gathers_one_child(1, ops.NARROW_WIDTH - 1)  # narrow one-child hops
    assert not gathers_one_child(0, 4500) and not gathers_one_child(2, 4500)


def _mark_runs(keys, e0, s0, rows, threads):
    """``segmented_rows.cuh:mark_runs``: one strided pass, a batch of
    ``threads`` edges at a time; returns each row's run ``[first, stop)``
    (absolute edge offsets, ``None`` for a row no edge opens) and the end
    of the tile's edges."""
    n, e, marked = len(keys), e0, {}
    while True:
        count = 0
        for i in range(e, min(e + threads, n)):
            k = int(keys[i])
            if k >= s0 + rows:
                break
            assert k >= s0
            count += 1
            if i == e0 or keys[i - 1] != k:
                marked.setdefault(k, [None, None])[0] = i
            if i + 1 == n or keys[i + 1] != k:
                marked.setdefault(k, [None, None])[1] = i + 1
        e += count
        if count < threads:
            return marked, e


def _gather_walk(keys, index, rows_of, scalar, scales, src, num_rows, d, plan, identity, fold):
    """What each block of the slab-major warp walk does, block by block in
    launch order and lane by lane: the search and marking of the tile's
    runs; per warp and row, per 128-column chunk of the slab (4 adjacent
    columns per lane; the access width the pointers allow moves the same
    values), batches of 32 edges whose operand row (-1 where out of range)
    and scalar one lane each loads for the warp; ``plan.in_flight`` gathers
    per lane before it folds any, then the folds in edge order.  Returns
    the output and how often each element was written."""
    n, R, U = len(keys), plan.rows_per_block, plan.in_flight
    out = np.full((num_rows, d), np.nan, np.float32)
    writes = np.zeros((num_rows, d), np.int64)
    lane_cols = np.arange(32)[:, None] * 4 + np.arange(4)  # (32 lanes, 4 columns)
    for block in range(plan.blocks):
        tile, slab = _block_cell(plan, block)
        s0 = tile * R
        rows = min(R, num_rows - s0)
        threads = 32 * plan.warps
        e0 = _block_lower_bound(keys, 0, n, s0, threads)
        marked, _ = _mark_runs(keys, e0, s0, rows, threads)
        c0, c1 = slab * plan.slab, min(d, (slab + 1) * plan.slab)
        for warp in range(plan.warps):
            for r in range(warp, rows, plan.warps):
                st, en = marked.get(s0 + r, (e0, e0))
                for cc in range(c0, c1, 128):
                    cols = cc + lane_cols
                    live = cols < c1
                    cols = np.where(live, cols, 0)
                    acc = np.full(cols.shape, identity, np.float32)
                    for base in range(st, en, 32):
                        m = min(32, en - base)
                        batch = index[base:base + m]  # one edge per lane
                        loaded = np.where((batch >= 0) & (batch < rows_of), batch, -1)
                        w = scalar[base:base + m]
                        for j in range(0, m, U):
                            group = [u for u in range(j, min(j + U, m)) if loaded[u] >= 0]
                            gathered = {u: src[loaded[u]][cols] for u in group}
                            for u in group:  # folds in edge order
                                acc = fold(acc, scales(base + u, w[u], cols), gathered[u])
                    out[s0 + r, cols[live]] = acc[live]
                    writes[s0 + r, cols[live]] += 1
    return out, writes


_F32 = np.float32
_FOLDS = {
    "sum": (_F32(0), lambda acc, s, x: acc + s * x),
    "min": (_F32(np.inf), lambda acc, s, x: np.fmin(acc, s + x)),
    "max": (_F32(-np.inf), lambda acc, s, x: np.fmax(acc, s + x)),
}

# (n, num_rows, operand rows, d, key range, label)
GATHER_CASES = [
    (600, 37, 25, 300, (0, 37), "d % 4 == 0, three slabs"),
    (500, 20, 25, 130, (0, 20), "d % 4 == 2: a lane with 2 columns"),
    (400, 20, 25, 33, (0, 20), "odd d < W"),
    (400, 13, 25, 129, (-3, 16), "d = W + 1, keys out of range"),
    (300, 40, 25, 258, (0, 40), "d % 4 == 2, three slabs"),
    (300, 40, 25, 131, (0, 40), "d % 4 == 3"),
    (60, 300, 25, 64, (0, 300), "mostly empty rows"),
    (0, 9, 5, 100, (0, 9), "no edges"),
]


def _gather_inputs(rng, n, num_rows, K, d, key_lo, key_hi, index_lo=-2):
    keys = np.sort(rng.integers(key_lo, key_hi, n))
    index = rng.integers(index_lo, K + 2, n)  # some out of range
    src = _data(rng, (K, d))
    return keys, index, src


@pytest.mark.parametrize("n,num_rows,K,d,key_range,label", GATHER_CASES)
def test_gather_walk_mirror_reproduces_coo_spmm(n, num_rows, K, d, key_range, label):
    rng = np.random.default_rng(n + d)
    keys, cols, dense = _gather_inputs(rng, n, num_rows, K, d, *key_range)
    vals = rng.integers(1, 9, n).astype(np.float32)
    plan = ops.gather_plan(n, num_rows, d)
    identity, fold = _FOLDS["sum"]
    got, writes = _gather_walk(
        keys, cols, K, vals, lambda e, w, c: w, dense, num_rows, d, plan, identity, fold,
    )
    assert np.all(writes == 1)
    want = port_ref.coo_spmm(torch.from_numpy(keys), torch.from_numpy(cols),
                             torch.from_numpy(vals), torch.from_numpy(dense), num_rows)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("kind,k", [("sum", 1), ("sum", 2), ("sum", 3), ("min", 1), ("max", 1)])
@pytest.mark.parametrize("n,num_rows,K,d,key_range,label", GATHER_CASES)
def test_gather_walk_mirror_reproduces_one_child_fused_hop(
    n, num_rows, K, d, key_range, label, kind, k
):
    d -= d % k  # rows of width * k floats
    rng = np.random.default_rng(n + d + k)
    keys, idx, msg = _gather_inputs(rng, n, num_rows, K, d, *key_range)
    w = rng.integers(0, 4 if kind == "sum" else 50, (n, k)).astype(np.float32)
    if kind != "sum":  # child rows at the identity
        msg[rng.choice(K, 4, replace=False)] = np.inf if kind == "min" else -np.inf
    plan = ops.gather_plan(n, num_rows, d)
    identity, fold = _FOLDS[kind]
    got, writes = _gather_walk(
        keys, idx, K, w[:, 0], lambda e, we, c: w[e][c % k] if k > 1 else we, msg,
        num_rows, d, plan, identity, fold,
    )
    assert np.all(writes == 1)
    want = port_ref.fused_hop(torch.from_numpy(keys), torch.from_numpy(w),
                              [torch.from_numpy(msg)], [torch.from_numpy(idx)],
                              num_rows, k, kind)
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "sum" and k == 1:  # the same hop through coo_spmm's plain version
        np.testing.assert_array_equal(
            got, port_ref.coo_spmm(torch.from_numpy(keys), torch.from_numpy(idx),
                                   torch.from_numpy(w[:, 0]), torch.from_numpy(msg),
                                   num_rows).numpy())


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_gather_walk_mirror_one_run_of_thousands_of_edges(kind):
    """One key run of 3,000 edges: ninety-four 32-edge batches, each split
    into groups of gathers in flight."""
    rng = np.random.default_rng(5)
    n, num_rows, K, d = 3000, 3, 40, 40
    keys = np.full(n, 1)
    idx = rng.integers(-1, K + 1, n)
    msg = rng.integers(-1, 2, (K, d)).astype(np.float32)
    w = rng.integers(0, 3, (n, 1)).astype(np.float32)
    identity, fold = _FOLDS[kind]
    for in_flight in ops.GATHER_IN_FLIGHT_CHOICES:
        plan = ops.make_gather_plan(n, num_rows, d, in_flight=in_flight)
        got, writes = _gather_walk(keys, idx, K, w[:, 0], lambda e, we, c: we, msg, num_rows,
                                   d, plan, identity, fold)
        assert np.all(writes == 1)
        want = port_ref.fused_hop(torch.from_numpy(keys), torch.from_numpy(w),
                                  [torch.from_numpy(msg)], [torch.from_numpy(idx)],
                                  num_rows, 1, kind)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("slab,rows,warps,in_flight,slab_major", [
    (32, 4, 4, 1, True), (64, 16, 2, 4, False), (128, 32, 4, 8, True),
    (256, 16, 4, 4, True), (32, 1, 1, 8, False),
])
def test_gather_walk_mirror_same_bits_for_every_candidate_plan(
    slab, rows, warps, in_flight, slab_major
):
    """What tools/walk_sweep.py holds on the card: any plan the kernel
    takes gives the chosen plan's bits."""
    rng = np.random.default_rng(slab + rows)
    n, num_rows, K, d = 500, 45, 30, 260
    keys, cols, dense = _gather_inputs(rng, n, num_rows, K, d, -2, num_rows + 2)
    vals = rng.integers(1, 9, n).astype(np.float32)
    plan = ops.make_gather_plan(n, num_rows, d, slab, rows, warps, in_flight, slab_major)
    _check_gather_plan(plan, n, num_rows, d)
    identity, fold = _FOLDS["sum"]
    got, writes = _gather_walk(keys, cols, K, vals, lambda e, w, c: w, dense, num_rows, d,
                               plan, identity, fold)
    assert np.all(writes == 1)
    want = port_ref.coo_spmm(torch.from_numpy(keys), torch.from_numpy(cols),
                             torch.from_numpy(vals), torch.from_numpy(dense), num_rows)
    np.testing.assert_array_equal(got, want.numpy())


# ----------------------------------------------------------------------
# fused_hop: the three-dispatch contract from repro.kernels.ref
# ----------------------------------------------------------------------

HOP_KINDS = [("sum", 1), ("sum", 3), ("min", 1), ("max", 1)]


def _three_dispatch(keys, w, msgs, idxs, s, k, kind):
    """Take each child's rows, multiply (add) them in child order, then
    reduce with ``segment_sum_ref``/``segment_reduce_ref`` — the
    three-dispatch path that ``tests/test_fused_hop.py:_oracle`` mirrors."""
    vals = np.asarray(w, np.float32).reshape(len(keys), 1, k)
    for msg, idx in zip(msgs, idxs):
        rows = np.asarray(
            jnp.take(jnp.asarray(msg.reshape(msg.shape[0], -1, k)), jnp.asarray(idx), axis=0)
        )
        prod = vals[:, :, None, :] * rows[:, None] if kind == "sum" else (
            vals[:, :, None, :] + rows[:, None]
        )
        vals = prod.reshape(len(keys), -1, k)
    flat = jnp.asarray(vals.reshape(len(keys), -1))
    ids = jnp.asarray(keys, jnp.int32)
    if kind == "sum":
        return np.asarray(jref.segment_sum_ref(flat, ids, s))
    return np.asarray(jref.segment_reduce_ref(flat, ids, s, kind))


def _hop(rng, n, s, k, kind, widths, rows=7, infinite_rows=0, key_lo=0):
    keys = np.sort(rng.integers(key_lo, s, n))
    hi = 4 if kind == "sum" else 50
    w = rng.integers(0, hi, (n, k)).astype(np.float32)
    msgs, idxs = [], []
    for wc in widths:
        msg = rng.integers(-3, 4, (rows, wc * k)).astype(np.float32)
        if infinite_rows:
            msg[rng.choice(rows, infinite_rows, replace=False)] = (
                np.inf if kind == "min" else -np.inf
            )
        msgs.append(msg)
        idxs.append(rng.integers(0, rows, n))
    return keys, w, msgs, idxs


def _port_hop(keys, w, msgs, idxs, s, k, kind):
    return fused_hop(
        torch.from_numpy(keys), torch.from_numpy(w),
        [torch.from_numpy(m) for m in msgs], [torch.from_numpy(i) for i in idxs],
        s, k, kind,
    ).numpy()


@pytest.mark.parametrize("widths", [(), (3,), (2, 5), (2, 3, 4)])
@pytest.mark.parametrize("kind,k", HOP_KINDS)
def test_fused_hop_matches_three_dispatch(kind, k, widths):
    rng = np.random.default_rng(len(widths) * 10 + k)
    inf_rows = 2 if widths and kind != "sum" else 0  # ±inf identity rows
    hop = _hop(rng, 300, 23, k, kind, widths, infinite_rows=inf_rows)
    want = _three_dispatch(*hop, 23, k, kind)
    got = _port_hop(*hop, 23, k, kind)
    assert got.shape == (23, int(np.prod(widths, dtype=int)) * k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,k", HOP_KINDS)
def test_fused_hop_edge_cases(kind, k):
    rng = np.random.default_rng(9)
    ident = {"sum": 0.0, "min": np.inf, "max": -np.inf}[kind]
    # zero edges: every row holds the identity
    keys, w, msgs, idxs = _hop(rng, 0, 5, k, kind, (2, 3))
    got = _port_hop(keys, w, msgs, idxs, 5, k, kind)
    np.testing.assert_array_equal(got, np.full((5, 6 * k), ident, np.float32))
    # one segment; keys out of range on both ends are dropped
    keys, w, msgs, idxs = _hop(rng, 200, 1, k, kind, (4,), key_lo=-2)
    keys[-3:] = 1
    np.testing.assert_array_equal(
        _port_hop(keys, w, msgs, idxs, 1, k, kind),
        _three_dispatch(keys, w, msgs, idxs, 1, k, kind),
    )
    # child rows all at the identity (min/max), and an edge indexing past
    # a child
    inf_rows = 0 if kind == "sum" else 4
    keys, w, msgs, idxs = _hop(rng, 60, 9, k, kind, (3, 2), rows=4, infinite_rows=inf_rows)
    want = _three_dispatch(keys, w, msgs, idxs, 9, k, kind)
    got = _port_hop(keys, w, msgs, idxs, 9, k, kind)
    np.testing.assert_array_equal(got, want)
    idxs[1][0] = 4  # row 4 of a 4-row child: the edge contributes nothing
    dropped = _three_dispatch(keys[1:], w[1:], msgs, [i[1:] for i in idxs], 9, k, kind)
    np.testing.assert_array_equal(_port_hop(keys, w, msgs, idxs, 9, k, kind), dropped)


def test_fused_hop_out_argument_and_plain_version_agree():
    rng = np.random.default_rng(2)
    keys, w, msgs, idxs = (
        [torch.from_numpy(np.asarray(x)) for x in part] if isinstance(part, list)
        else torch.from_numpy(part)
        for part in _hop(rng, 50, 6, 2, "sum", (3,))
    )
    out = torch.full((6, 6), 99.0)
    assert fused_hop(keys, w, msgs, idxs, 6, 2, out=out) is out
    assert torch.equal(out, port_ref.fused_hop(keys, w, msgs, idxs, 6, 2))


def test_fused_hop_argument_checks():
    keys, w = torch.zeros(4, dtype=torch.int64), torch.ones(4, 1)
    msg, idx = torch.ones(2, 1), torch.zeros(4, dtype=torch.int64)
    over = MAX_CHILDREN + 1
    with pytest.raises(ValueError, match=f"{over} children exceed the kernel's limit of 64"):
        fused_hop(keys, w, [msg] * over, [idx] * over, 3)
    assert fused_hop(keys, w, [msg] * MAX_CHILDREN, [idx] * MAX_CHILDREN, 3).shape == (3, 1)
    with pytest.raises(ValueError, match="weights must be a contiguous 2-d torch.float32"):
        fused_hop(keys, w.double(), [msg], [idx], 3)
    with pytest.raises(ValueError, match="idxs\\[0\\] must be a contiguous 1-d torch.int64"):
        fused_hop(keys, w, [msg], [idx.int()], 3)
    with pytest.raises(ValueError, match="msgs\\[0\\] must be a contiguous"):
        fused_hop(keys, w, [torch.ones(3, 2).T], [idx], 3)
    with pytest.raises(ValueError, match="min/max k = 1"):
        fused_hop(keys, torch.ones(4, 2), [], [], 3, k=2, kind="min")
    with pytest.raises(ValueError, match="unknown hop kind"):
        fused_hop(keys, w, [], [], 3, kind="avg")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_hop(keys.to("meta"), w.to("meta"), [msg.to("meta")], [idx.to("meta")], 3)
    with pytest.raises(ValueError, match="different devices"):
        fused_hop(keys, w, [msg.to("meta")], [idx], 3)


# ----------------------------------------------------------------------
# semiring_matmul
# ----------------------------------------------------------------------

SEMIRINGS = ["add_mul", "max_add", "min_add", "or_and"]
MATMUL_SHAPES = [(5, 7, 3), (33, 17, 65), (1, 1, 1), (64, 16, 64), (70, 130, 9)]


@pytest.mark.parametrize("m,kd,n", MATMUL_SHAPES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_semiring_matmul_matches_jax_ref(semiring, m, kd, n):
    rng = np.random.default_rng(m * 3 + kd + n)
    a = rng.integers(-3, 4, (m, kd)).astype(np.float32)
    b = rng.integers(-3, 4, (kd, n)).astype(np.float32)
    if semiring in ("max_add", "min_add"):
        inf = -np.inf if semiring == "max_add" else np.inf  # the identity
        a[rng.random((m, kd)) < 0.2] = inf
        b[rng.random((kd, n)) < 0.2] = inf
    want = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a), jnp.asarray(b), semiring))
    got = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    np.testing.assert_array_equal(got.numpy(), want)


def test_semiring_matmul_empty_k_and_argument_checks():
    a, b = torch.ones(3, 0), torch.ones(0, 4)
    for semiring, ident in zip(SEMIRINGS, (0.0, -np.inf, np.inf, 0.0)):
        assert torch.all(semiring_matmul(a, b, semiring) == ident)
    out = torch.full((2, 2), 7.0)
    assert semiring_matmul(torch.ones(2, 3), torch.ones(3, 2), out=out) is out
    assert torch.all(out == 3.0)
    with pytest.raises(ValueError, match="unknown semiring"):
        semiring_matmul(torch.ones(2, 2), torch.ones(2, 2), "max_mul")
    with pytest.raises(ValueError, match="shapes"):
        semiring_matmul(torch.ones(2, 3), torch.ones(2, 2))
    with pytest.raises(ValueError, match="torch.float32"):
        semiring_matmul(torch.ones(2, 2, dtype=torch.float64), torch.ones(2, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        semiring_matmul(torch.ones(2, 2, device="meta"), torch.ones(2, 2, device="meta"))


# ----------------------------------------------------------------------
# semiring_matmul's plain version: the exact FMA step, fractional add_mul
# ----------------------------------------------------------------------


def _libm_fmaf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.fmaf
    fn.argtypes = [ctypes.c_float] * 3
    fn.restype = ctypes.c_float
    return fn


def _fma_triples(rng, kind: str, n: int) -> list[np.ndarray]:
    """Seeded float32 triples: normal values, wide exponents, subnormal
    products and addends, specials (±inf, NaN, ±0) among normals, random
    bit patterns, and sums that cancel to the product's rounding error."""
    if kind == "normal":
        return [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    if kind == "wide":
        return [(rng.standard_normal(n) * 2.0 ** rng.integers(-140, 120, n)).astype(np.float32)
                for _ in range(3)]
    if kind == "subnormal":
        tiny = [(rng.standard_normal(n) * 2.0 ** rng.integers(-80, -60, n)).astype(np.float32)
                for _ in range(2)]
        return tiny + [(rng.standard_normal(n) * 2.0 ** -135).astype(np.float32)]
    if kind == "special":
        out = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
        specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)
        for x in out:
            pick = rng.random(n) < 0.3
            x[pick] = rng.choice(specials, pick.sum())
        return out
    if kind == "bits":
        return [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
                for _ in range(3)]
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))  # "cancel"
    return [a, b, (-(a.astype(np.float64) * b)).astype(np.float32)]


@pytest.mark.parametrize("kind", ["normal", "wide", "subnormal", "special", "bits", "cancel"])
def test_fma_step_matches_libm_fmaf(kind):
    a, b, c = _fma_triples(np.random.default_rng(len(kind)), kind, 4000)
    fmaf = _libm_fmaf()
    want = np.array([fmaf(x, y, z) for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())],
                    np.float32)
    got = port_ref.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{(~same).sum()} of {len(a)} differ from fmaf"


@pytest.mark.parametrize("m,kd,n", [(33, 300, 65), (64, 1000, 16), (7, 5, 3)])
def test_semiring_matmul_add_mul_fractional_within_bound_of_jax_ref(m, kd, n):
    # jnp.dot promises no summation order, so the two agree to within the
    # error of a kd-term float32 sum, kd 2**-24 (|A| |B|) elementwise
    rng = np.random.default_rng(m + kd + n)
    a = rng.uniform(-1, 1, (m, kd)).astype(np.float32)
    b = rng.uniform(-1, 1, (kd, n)).astype(np.float32)
    want = np.asarray(jref.semiring_matmul_ref(jnp.asarray(a), jnp.asarray(b), "add_mul"))
    got = semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), "add_mul").numpy()
    tol = kd * 2.0**-24 * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


# ----------------------------------------------------------------------
# semiring_matmul's launch plan (kernels/ops.py:matmul_plan), the or_and
# packing, and csrc/semiring_matmul.cu's tile loop mirrored block by
# block, thread by thread, stage by stage
# ----------------------------------------------------------------------

_MATMUL_PAD = {"add_mul": 0.0, "max_add": -np.inf, "min_add": np.inf, "or_and": 0}
_MATMUL_IDENTITY = {"add_mul": 0.0, "max_add": -np.inf, "min_add": np.inf, "or_and": 0}


def _check_matmul_plan(plan, m, n, kd, semiring, align=16):
    bm, bn, bk = plan.block_m, plan.block_n, plan.block_k
    assert (bm, bn, bk) in ops.MATMUL_TILES
    # the blocks cover C once: tile rows and columns partition [0, m) x [0, n)
    assert plan.tiles_m * bm >= m > (plan.tiles_m - 1) * bm
    assert plan.tiles_n * bn >= n > (plan.tiles_n - 1) * bn
    assert plan.blocks == plan.tiles_m * plan.tiles_n <= ops.MAX_BLOCKS
    # two stages of A (bk x bm) and B (bk x bn) fit in static shared memory
    assert plan.smem_bytes == ops.MATMUL_STAGES * bk * (bm + bn) * 4 <= ops.SMEM_LIMIT
    if semiring == ops.PACKED:
        assert plan.vec == 4 and plan.k_steps % 4 == 0 and plan.ldb % 4 == 0
        assert plan.k_steps * 32 >= kd > (plan.k_steps - 4) * 32 or kd == plan.k_steps == 0
        assert plan.ldb - 4 < n <= plan.ldb
    else:
        assert (plan.k_steps, plan.ldb) == (kd, n)
        fits = [v for v in ops.MATMUL_VECS if align % (4 * v) == 0 and kd % v == 0 and n % v == 0]
        assert plan.vec == max(fits)


@settings(max_examples=300, deadline=None)
@given(
    m=st.integers(1, 2**20), n=st.integers(1, 2**20), kd=st.integers(0, 2**20),
    semiring=st.sampled_from(SEMIRINGS), align=st.sampled_from([4, 8, 16]),
    tile=st.sampled_from(ops.MATMUL_TILES),
)
def test_matmul_plan_arithmetic(m, n, kd, semiring, align, tile):
    _check_matmul_plan(ops.matmul_plan(m, n, kd, semiring, align=align), m, n, kd, semiring, align)
    plan = ops.matmul_plan(m, n, kd, semiring, tile=tile, align=align)
    _check_matmul_plan(plan, m, n, kd, semiring, align)


@pytest.mark.parametrize("m,kd,n,offset,semiring,vec", [
    (2048, 2048, 2048, 0, "add_mul", 4),
    (3000, 1000, 2500, 0, "max_add", 4),
    (256, 512, 384, 1, "add_mul", 1),  # operands 4 bytes off 16-byte alignment
    (256, 512, 384, 2, "min_add", 2),  # 8 bytes off
    (256, 33, 384, 0, "add_mul", 1),  # odd kd: rows of A start anywhere
    (256, 512, 386, 0, "max_add", 2),
    (65, 33, 129, 1, "or_and", 4),  # or_and reads its own packed words
])
def test_matmul_plan_alignment_picks_the_access_width(m, kd, n, offset, semiring, vec):
    buf = torch.zeros(m * kd + kd * n + 16)
    a = buf[offset:offset + m * kd].view(m, kd)
    b = buf[offset + 4 * -(-m * kd // 4):][: kd * n].view(kd, n)
    align = ops.alignment(a, b)
    assert align == {0: 16, 1: 4, 2: 8}[offset]
    plan = ops.matmul_plan(m, n, kd, semiring, align=align)
    _check_matmul_plan(plan, m, n, kd, semiring, align)
    assert plan.vec == vec


def test_matmul_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="m, n >= 1"):
        ops.matmul_plan(0, 4, 4, "add_mul")
    with pytest.raises(ValueError, match="block tile"):
        ops.matmul_plan(4, 4, 4, "add_mul", tile=(64, 64, 8))
    with pytest.raises(ValueError, match="floats per access"):
        ops.matmul_plan(4, 4, 4, "add_mul", vec=4, align=8)
    with pytest.raises(ValueError, match="floats per access"):
        ops.matmul_plan(4, 4, 4, "or_and", vec=2)
    with pytest.raises(ValueError, match="more than one launch has"):
        ops.matmul_plan(2**40, 2**40, 4, "add_mul")
    assert ctypes.sizeof(ops.MatmulPlan) == 80  # ReproMatmulPlan, field for field


@pytest.mark.parametrize("kd", [1, 31, 32, 77, 130])
def test_or_and_packing_matches_positive(kd):
    rng = np.random.default_rng(kd)
    x = rng.standard_normal((9, kd)).astype(np.float32)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
    pick = rng.random(x.shape) < 0.3
    x[pick] = rng.choice(specials, pick.sum())
    words = ops.matmul_plan(9, 5, kd, "or_and").k_steps
    packed = port_ref.pack_positive(torch.from_numpy(x), words).numpy().view(np.uint32)
    assert packed.shape == (9, words)
    bits = (packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(9, words * 32).astype(bool)
    np.testing.assert_array_equal(bits[:, :kd], x > 0)
    assert not bits[:, kd:].any()


def _lane_cells(bm, bn):
    """``tiled_kernel``'s register tile: the (row, column) cells of the
    block tile that each of the 256 threads folds, 8 warps as 4 x 2, a
    warp as 4 x 8 lanes, each lane bm / 64 x bn / 64 groups of 4 x 4."""
    cells = []
    for tid in range(ops.MATMUL_THREADS):
        warp, lane = divmod(tid, 32)
        tr = (warp // 2) * (bm // 4) + (lane // 8) * 4
        tc = (warp % 2) * (bn // 2) + (lane % 8) * 4
        rows = [tr + 16 * g + i for g in range(bm // 64) for i in range(4)]
        cols = [tc + 32 * g + j for g in range(bn // 64) for j in range(4)]
        cells.append((rows, cols))
    return cells


def _mirror_tile_loop(a, b, semiring, plan):
    """``csrc/semiring_matmul.cu:tiled_kernel`` in numpy: per block, every
    stage's shared A (k-major, the semiring's pad past kd) and B (0 past kd
    and n) filled piece by piece as the threads load them, then each
    cell's ascending-k fold, stored where the row and column exist."""
    bm, bn, bk, vec = plan.block_m, plan.block_n, plan.block_k, plan.vec
    m, n_out = a.shape[0], b.shape[1]
    if semiring == ops.PACKED:
        big_a = port_ref.pack_positive(a, plan.k_steps).numpy().view(np.uint32)
        big_b = np.zeros((plan.k_steps, plan.ldb), np.uint32)
        big_b[:, :n_out] = port_ref.pack_positive(b.T, plan.k_steps).numpy().view(np.uint32).T
    else:
        big_a, big_b = a.numpy(), b.numpy()
    kd, n = plan.k_steps, plan.ldb
    dtype = big_a.dtype
    threads = ops.MATMUL_THREADS
    b_row = bn // vec
    b_total = bk * bn // vec

    def step(acc, x, y):
        if semiring == "add_mul":
            return port_ref.fma(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(acc)).numpy()
        if semiring == ops.PACKED:
            return acc | (x & y)
        with np.errstate(invalid="ignore", over="ignore"):
            return (np.maximum if semiring == "max_add" else np.minimum)(acc, x + y)

    cells = _lane_cells(bm, bn)
    cover = np.zeros((bm, bn), np.int64)
    for rows, cols in cells:
        cover[np.ix_(rows, cols)] += 1
    assert np.all(cover == 1)  # every cell of the block tile has one owner
    out = np.full((m, n_out), 7777.0, np.float32)
    written = np.zeros((m, n_out), np.int64)
    for block in range(plan.blocks):
        row0, col0 = (block // plan.tiles_n) * bm, (block % plan.tiles_n) * bn
        acc = np.full((bm, bn), _MATMUL_IDENTITY[semiring], dtype)
        for t in range(-(-kd // bk)):
            sa, sb = np.zeros((bk, bm), dtype), np.zeros((bk, bn), dtype)
            na, nb = np.zeros((bk, bm), np.int64), np.zeros((bk, bn), np.int64)
            for tid in range(threads):
                ar = tid % bm
                for i in range(bm * bk // vec // threads):
                    kv = ((tid + i * threads) // bm) * vec
                    k = t * bk + kv
                    ok = row0 + ar < m and k < kd
                    sa[kv:kv + vec, ar] = big_a[row0 + ar, k:k + vec] if ok else _MATMUL_PAD[semiring]
                    na[kv:kv + vec, ar] += 1
                bc = (tid % b_row) * vec
                for i in range(-(-b_total // threads)):
                    p = tid + i * threads
                    if p >= b_total:
                        continue
                    br = p // b_row
                    k = t * bk + br
                    ok = col0 + bc < n and k < kd
                    sb[br, bc:bc + vec] = big_b[k, col0 + bc:col0 + bc + vec] if ok else 0
                    nb[br, bc:bc + vec] += 1
            assert np.all(na == 1) and np.all(nb == 1)  # each shared cell loaded once
            for kk in range(bk):
                acc = step(acc, sa[kk][:, None], sb[kk][None, :])
        res = (acc != 0).astype(np.float32) if semiring == ops.PACKED else acc
        for rows, cols in cells:
            for r in rows:
                for c in cols:
                    if row0 + r < m and col0 + c < n_out:
                        out[row0 + r, col0 + c] = res[r, c]
                        written[row0 + r, col0 + c] += 1
    assert np.all(written == 1)  # every element of C stored once
    return out


@pytest.mark.parametrize("tile", ops.MATMUL_TILES)
@pytest.mark.parametrize("m,kd,n,tail_infs", [
    (130, 70, 132, True),  # two tile rows, ragged last stage, ±inf in the last k only
    (5, 33, 200, False),  # odd kd: 4-byte accesses; two tile columns
    (70, 18, 66, True),  # kd and n even: 8-byte accesses
    (1, 1, 1, False),
    (9, 0, 7, False),  # empty k: the identity
])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_matmul_tile_mirror_matches_plain(semiring, m, kd, n, tail_infs, tile):
    rng = np.random.default_rng(m * 7 + kd + n)
    a = rng.standard_normal((m, kd)).astype(np.float32)
    b = rng.standard_normal((kd, n)).astype(np.float32)
    if tail_infs and kd > 4:
        a[:, -4:][rng.random((m, 4)) < 0.3] = np.inf
        a[:, -4:][rng.random((m, 4)) < 0.3] = -np.inf
        b[-4:][rng.random((4, n)) < 0.3] = -np.inf
    a[rng.random(a.shape) < 0.02] = np.nan
    plan = ops.matmul_plan(m, n, kd, semiring, tile=tile)
    got = _mirror_tile_loop(torch.from_numpy(a), torch.from_numpy(b), semiring, plan)
    want = port_ref.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring).numpy()
    np.testing.assert_array_equal(got, want)
