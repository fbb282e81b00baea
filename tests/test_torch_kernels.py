"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's jnp references, on the shapes of
``tests/test_kernels.py`` plus sorted, out-of-range and sparse ids.

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
from repro_torch.kernels.coo_spmm import coo_spmm
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.kernels.segment_sum import segment_sum

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
