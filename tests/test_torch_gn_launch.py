"""The launch shape of the GN cluster kernel (K1, K4, K5): how one
stream's N queries x NC candidate slots split over a thread-block cluster
of C CTAs. Pure arithmetic, checked on the CPU at the shapes the paths use
(4096 x 80 on the fast and LIO paths and the 8-stream drive, 512 x 16 on
Monte-Carlo, 512 x 80 on the small drives, 1024 and 128 in the tests) and
at ragged ones."""

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
