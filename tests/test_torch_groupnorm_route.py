"""The GroupNorm+FiLM+SiLU kernel's route (B.3): which launch each call takes, and the statistics of a cluster.

``groupnorm.gn_route`` is plain Python: from a call's shape and the number of
clusters of each shape the card holds at once (on the card,
cudaOccupancyMaxActiveClusters; here the counts measured on an H100 80GB
HBM3, or a stand-in model of that card), it picks the cluster route (one
launch, a cluster of 2, 4 or 8 CTAs for each (batch, group) slab) or, for a
slab that no cluster holds, the two-pass route. The cluster route sums each
CTA's share of a slab and combines the CTAs' partial sums in rank order; a
plain emulation of that is held against ``group_stats``. The kernel itself
is held against its plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from tedm_tpu_torch.kernels import bounds
from tedm_tpu_torch.kernels import groupnorm as G

torch.set_num_threads(1)

H100_SMEM_PER_SM = 233472  # 228 KB an SM, of which a block may take 227 KB


def h100(cluster: int, smem: int) -> int:
    """A stand-in for the card's count of active clusters: CTAs an SM by
    shared memory (1 KB reserved a block) and by threads, over 132 SMs."""
    per_sm = min(2048 // G.CLUSTER_THREADS, H100_SMEM_PER_SM // (smem + 1024))
    return 132 * per_sm // cluster


# cudaOccupancyMaxActiveClusters on an H100 80GB HBM3 (700 W) for the cluster
# kernel with fp32 x, by cluster size, at two call shapes (scripts/port/kernel_sweeps.py)
MEASURED = {(8, 64, 128 * 128): {4: 30, 8: 45}, (8, 512, 16 * 16): {2: 264, 4: 124, 8: 62}}


def _calls():
    _, res = bounds.unet_stages()
    return sorted({(c_out, s * s) for _, c_out, s in res})


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [8, 16])
def test_every_unet_call_takes_the_cluster_route(batch, itemsize):
    _, res = bounds.unet_stages()
    assert 2 * len(res) == 38
    for c, hw in _calls():
        route = G.gn_route(batch, c, hw, itemsize, h100)
        assert route.cluster in (2, 4, 8) and route.cluster <= 16
        assert route.smem == G.cluster_smem(c, hw, itemsize, route.cluster) <= 227 * 1024
        # the CTAs' shares cover the slab, and each holds its share
        share = route.smem - 16 - 8 * (c // 8)
        assert route.cluster * share >= (c // 8) * hw * itemsize


def test_a_slab_no_cluster_holds_takes_two_passes():
    """img_size 256 at C = 64: a 2 MB fp32 slab; 1 MB in bf16 fits 8 CTAs."""
    assert G.gn_route(1, 64, 256 * 256, 4, h100) == G.TWO_PASS
    assert G.gn_route(1, 64, 256 * 256, 2, h100).cluster == 8
    assert G.gn_route(1, 8 * (G.CLUSTER_THREADS + 1), 1, 4, h100) == G.TWO_PASS  # a channel a thread


def test_route_takes_the_fewest_rounds_then_the_smallest_cluster():
    """With the card's own counts: (8, 64, 128^2) fp32 runs its 64 clusters
    in 2 rounds of 8 CTAs (45 at once) against 3 of 4 (30; pairs of CTAs do
    not fit), and (8, 512, 16^2) in one round of 2."""
    for (b, c, hw), counts in MEASURED.items():
        fits = {s for s in (2, 4, 8) if G.cluster_smem(c, hw, 4, s) <= G.SMEM_PER_CTA}
        active = lambda s, smem, counts=counts: counts[s]
        assert set(counts) == fits
        route = G.gn_route(b, c, hw, 4, active)
        assert route.cluster == {64: 8, 512: 2}[c]


def test_route_raises_where_no_cluster_can_be_scheduled():
    with pytest.raises(RuntimeError, match="can schedule none"):
        G.gn_route(8, 64, 64 * 64, 4, lambda s, smem: 0)


def _cluster_stats(x: torch.Tensor, cluster: int, groups: int = 8, eps: float = 1e-5):
    """(mean, rstd) of each (batch, group) as the cluster route forms them:
    the slab's 16-byte units split into ``cluster`` shares, x and x^2 summed
    in fp32 over each share, the partials combined in rank order."""
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    per = 16 // x.element_size()
    share = -(-(-(-xf.shape[2] // per)) // cluster) * per
    s = torch.zeros(b, groups)
    q = torch.zeros(b, groups)
    for r in range(cluster):
        part = xf[:, :, r * share:(r + 1) * share]
        s = s + part.sum(dim=2)
        q = q + (part * part).sum(dim=2)
    n = xf.shape[2]
    mean = s / n
    return mean[..., None], torch.rsqrt(torch.clamp(q / n - mean * mean, min=0.0) + eps)[..., None]


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 16, 15, 17), (1, 512, 4, 4)])
def test_rank_ordered_partials_give_the_group_statistics(shape, dtype, cluster):
    """On x whose group means are +-3, as chip_smoke.gn_inputs makes it."""
    rs = np.random.RandomState(sum(shape) + cluster)
    b, c = shape[:2]
    offset = np.repeat(np.array([3.0, -3.0] * 4, dtype=np.float32), c // 8).reshape(1, c, 1, 1)
    x = (rs.randn(*shape) * (1 + np.abs(rs.randn(1, c, 1, 1))) + 0.3 * rs.randn(1, c, 1, 1) + offset)
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    mean, rstd = _cluster_stats(x, cluster)
    want_mean, want_rstd = G.group_stats(x)
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-6, atol=1e-6)
