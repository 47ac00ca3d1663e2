"""The launch shape of the GN cluster kernel (K1, K4, K5): how one
stream's N queries x NC candidate slots split over a thread-block cluster
of C CTAs, or (one large stream) over G clusters of C CTAs. Pure
arithmetic, checked on the CPU at the shapes the paths use (4096 x 80 on
the fast and LIO paths and the 8-stream drive, 512 x 16 on Monte-Carlo,
512 x 80 on the small drives, 16,384 x 80 on the dense drive, 1024 and 128
in the tests) and at ragged ones."""

import numpy as np
import pytest

from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn

GRID_X_MAX = 2**31 - 1  # CUDA's limit on gridDim.x
PATH_SHAPES = [(4096, 80), (512, 16), (512, 80), (1024, 80), (128, 80)]
RAGGED = [1, 31, 33, 100, 250, 257, 1000, 2049, 3841, 4097, 5000, 7681, 65536]


def _slices(n, clusters, per):
    return [(r * per, min(n, (r + 1) * per)) for r in range(clusters)]


@pytest.mark.parametrize("n,nc", PATH_SHAPES + [(n, 80) for n in RAGGED] + [(1000, 27)])
def test_every_query_in_exactly_one_cta(n, nc):
    c, per = icp_gn.launch_shape(n, nc)
    assert 1 <= c <= icp_gn.MAX_CLUSTER
    assert per % 32 == 0
    hits = np.zeros(n, np.int64)
    for lo, hi in _slices(n, c, per):
        assert hi > lo  # no CTA without queries
        assert lo % 32 == 0  # a slice starts on a whole warp
        hits[lo:hi] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("streams", [1, 8, 256])
@pytest.mark.parametrize("n,nc", PATH_SHAPES)
def test_grid_within_limits(streams, n, nc):
    c, _ = icp_gn.launch_shape(n, nc)
    assert streams * c <= GRID_X_MAX


def test_cluster_sizes_on_the_paths():
    assert icp_gn.launch_shape(4096, 80) == (16, 256)  # main path: >= 8 CTAs a stream
    assert icp_gn.launch_shape(512, 16)[0] == 1  # Monte-Carlo: 256 streams fill the card
    assert icp_gn.launch_shape(128, 80) == (1, 128)  # a cluster of one CTA


@pytest.mark.parametrize("clusters", [1, 2, 8, 16])
@pytest.mark.parametrize("n", [4096, 512, 1000])
def test_cluster_shape_at_a_given_size(n, clusters):
    c, per = icp_gn.cluster_shape(n, clusters)
    assert c <= clusters and (c - 1) * per < n <= c * per and per % 32 == 0


# A stream too large for one cluster (the dense preset's 16,384 x 80)
# spreads over G clusters of C CTAs: `spread_shape` at the clusters a card
# holds at once, `active` (per C), and the shared memory a CTA may take.
SPREAD_SHAPES = [(16384, 80), (9000, 80), (65536, 80), (4097, 80), (20000, 27), (16384, 81)]
ACTIVE = [{8: 16, 16: 7}, {8: 15, 16: 7}, {8: 8, 16: 4}, {8: 2, 16: 2}, {8: 16},
          {16: 8}, {8: 1, 16: 1}, {8: 40, 16: 40}, {}]


def _spread_slices(n, groups, clusters):
    """CTA b's queries: the whole warps [b W / K, (b + 1) W / K) of the
    W = ceil(N / 32) warps (csrc/icp_gn.cu, gn_spread_kernel)."""
    warps, ctas = -(-n // 32), groups * clusters
    return [(b * warps // ctas * 32, min(n, (b + 1) * warps // ctas * 32)) for b in range(ctas)]


@pytest.mark.parametrize("active", ACTIVE, ids=str)
@pytest.mark.parametrize("n,nc", SPREAD_SHAPES + PATH_SHAPES)
def test_spread_covers_every_query_once(n, nc, active):
    g, c, per, resident = icp_gn.spread_shape(n, nc, active)
    if g == 1:  # the one-cluster kernel at launch_shape's cluster
        assert (c, per) == icp_gn.launch_shape(n, nc) and not resident
        return
    assert c in icp_gn.SPREAD_CLUSTERS and 2 <= g <= min(active[c], icp_gn.MAX_GROUPS)
    assert per % 32 == 0
    hits = np.zeros(n, np.int64)
    for lo, hi in _spread_slices(n, g, c):
        assert hi > lo and lo % 32 == 0  # none empty, on whole warps
        assert hi - lo <= per
        hits[lo:hi] += 1
    assert (hits == 1).all()
    if resident:
        assert icp_gn.slab_bytes(per, nc) <= icp_gn.SMEM_BUDGET


@pytest.mark.parametrize("active", ACTIVE, ids=str)
def test_spread_leaves_the_one_cluster_paths_alone(active):
    assert icp_gn.spread_shape(4096, 80, active) == (1, 16, 256, False)
    assert icp_gn.spread_shape(512, 16, active)[0] == 1
    assert icp_gn.spread_shape(128, 80, active) == (1, 1, 128, False)


@pytest.mark.parametrize("count", [2, 3, 4, 7, 8, 15, 16, 32])
@pytest.mark.parametrize("c", [8, 16])
def test_spread_at_the_dense_shape(count, c):
    g, c_used, per, resident = icp_gn.spread_shape(16384, 80, {c: count})
    assert c_used == c and 2 <= g <= count
    assert g * c * per >= 16384
    # resident up to 224 queries x 80 slots (210 KB), not at 256 (240 KB);
    # about 128 queries a CTA (a query a thread pair) once the card holds
    # enough clusters
    assert resident == (per <= 224)
    if count * c >= 128:
        assert g * c == 128 and per == icp_gn.SPREAD_QUERIES and resident


def test_spread_prefers_a_resident_slice():
    # 8 clusters of 8 would need 256 queries a CTA (240 KB); 8 of 16, 128
    assert icp_gn.spread_shape(16384, 80, {8: 8, 16: 8}) == (8, 16, 128, True)
    assert icp_gn.spread_shape(16384, 80, {8: 16, 16: 8}) == (16, 8, 128, True)


@pytest.mark.parametrize("per,nc,nbytes", [(128, 80, 123_264), (160, 80, 153_984),
                                           (128, 81, 126_336), (32, 1, 1_152)])
def test_slab_bytes(per, nc, nbytes):
    assert icp_gn.slab_bytes(per, nc) == nbytes


def test_spread_split_rejects_empty_ctas():
    assert icp_gn.spread_split(4096, 80, 8, 16) == (8, 16, 32, True)
    with pytest.raises(ValueError):
        icp_gn.spread_split(4096, 80, 16, 16)  # 256 CTAs for 128 warps of queries
    with pytest.raises(ValueError):
        icp_gn.spread_split(16384, 80, 2, 32)  # a cluster above MAX_CLUSTER
    with pytest.raises(ValueError):
        icp_gn.spread_split(65536, 80, 33, 8)  # more clusters than rank 0 keeps sums of
    assert icp_gn.spread_split(16384, 80, 4, 16, smem=100_000) == (4, 16, 256, False)
