"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's jnp references, on the shapes of
``tests/test_kernels.py`` plus sorted, out-of-range and sparse ids; the
fused hop against the three-dispatch contract of
``tests/test_fused_hop.py`` built from ``repro.kernels.ref``.

Tolerance 0: the data are integer-valued float32 below 2**24, so every
sum is exact in any order.  The CUDA kernels themselves run only on a
card; ``chip_smoke.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
