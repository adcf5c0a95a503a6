"""The port's synthetic graphs (``repro_torch.data.synthetic``) against
the reference's (``repro.data.synthetic``), bit for bit: the inverse-CDF
lookups by ``torch.searchsorted`` and the stable ``torch.sort``, here on
the CPU."""
import numpy as np
import pytest

from repro.data.synthetic import powerlaw_temporal_graph as ref_graph
from repro_torch.data.synthetic import powerlaw_temporal_graph


@pytest.mark.parametrize("n,m,kw", [
    (512, 1 << 15, dict(skew=1.2, t_max=100_000, seed=2)),
    (4096, 50_000, dict(skew=1.5, t_max=1000, seed=7, ts_groups=50)),
    (40, 1200, dict(seed=9, t_max=1000, self_loops=True)),
])
def test_powerlaw_graph_is_the_reference_bit_for_bit(n, m, kw):
    want = ref_graph(n, m, **kw)
    got = powerlaw_temporal_graph(n, m, **kw)
    assert got.num_nodes == want.num_nodes
    for f in ("src", "dst", "ts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
