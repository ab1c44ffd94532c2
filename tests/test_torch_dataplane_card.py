"""On the card: the data plane's kernels write the repair buffer's rows in
place, held against the plain versions on the CPU.

`gf256_scale_batch` into named rows of a wider buffer and
`xor_reduce_segments` folded over its own rows (a held destination in its
own group, -1 pads, a ragged size padded to whole words), then whole
batches of `execute_plans_batch` on memory the caching allocator hands back dirty:
every restored byte, `verified` and `bytes_moved` equal the CPU run's.
This file imports no JAX, so it runs where the card is:
`python3 -m pytest -m card tests/test_torch_dataplane_card.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.engine import dataplane
from repro_torch.core.engine.arrays import compile_plan, relabel_plan_nodes
from repro_torch.core.simulator import Scenario, run_scheme
from repro_torch.core.topology import heterogeneous_matrix
from repro_torch.ec.rs import RSCode
from repro_torch.ec.stripe import place_stripes
from repro_torch.kernels import ops
from repro_torch.kernels.gf256_matmul import gf256_scale_bytes
from repro_torch.kernels.xor_reduce import xor_reduce_groups_words
from repro_torch.sim.suite import sample_failures

# a held destination in its own group, -1 pads, a K=1 group, a destination
# outside every group
GROUPS = np.array([[2, 0, 5, -1], [4, -1, -1, -1], [1, 6, 3, -1]])
DST = np.array([2, 7, 1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the kernels run only on one")
    return torch.device("cuda")


def _bytes(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.card
@pytest.mark.parametrize("nbytes", [1, 4099, (1 << 20) + 4])
def test_scale_into_rows_on_the_card(card, nbytes):
    rng = np.random.default_rng(nbytes)
    coeffs = rng.integers(0, 256, size=5, dtype=np.uint8)
    coeffs[:2] = (0, 1)
    data = _bytes(rng, 5, nbytes)
    rows = np.array([6, 0, 3, 8, 2])
    for width in (nbytes, nbytes + (-nbytes % 4), nbytes + 13):
        want = _bytes(rng, 9, width)
        out = want.to(card)
        launches = gf256_scale_bytes.launches
        ops.gf256_scale_batch(coeffs, data.to(card), out=out, out_rows=rows)
        assert gf256_scale_bytes.launches == launches + 1
        ops.gf256_scale_batch(coeffs, data, out=want, out_rows=rows,
                              use_kernel=False)
        assert torch.equal(out.cpu(), want)


@pytest.mark.card
@pytest.mark.parametrize("nbytes", [4, 4099, (1 << 20) + 4])
def test_fold_in_place_on_the_card(card, nbytes):
    """Rows padded to whole words, as the data plane pads them."""
    rng = np.random.default_rng(nbytes)
    want = _bytes(rng, 8, nbytes + (-nbytes % 4))
    got = want.to(card)
    launches = xor_reduce_groups_words.launches
    assert ops.xor_reduce_segments(got, GROUPS, out_rows=DST) is got
    assert xor_reduce_groups_words.launches == launches + 1
    ops.xor_reduce_segments(want, GROUPS, out_rows=DST, use_kernel=False)
    assert torch.equal(got.cpu(), want)


def _batches():
    """(plans, code, block maps) of the benchmark cells' traffic."""
    out = []
    for n, k, cluster, pattern, scheme in ((9, 6, 14, "single", "bmf"),
                                           (14, 10, 16, "rack", "msrepair")):
        code = RSCode(n, k)
        stripes = place_stripes(4, code, cluster)
        pas, bmaps = [], []
        for seed in range(4):
            failed = tuple(int(f) for f in sample_failures(
                np.random.default_rng(100 + seed), n, k, pattern))
            sc = Scenario(num_nodes=cluster, code=code, failed=failed,
                          bw=BandwidthProcess(base=heterogeneous_matrix(
                              cluster, low=3, high=30, seed=seed),
                              change_interval=2.0, seed=seed, mode="markov"),
                          ingress=IngressModel(seed=seed), chunk_mb=128.0)
            pas.append(relabel_plan_nodes(compile_plan(
                run_scheme(sc, scheme, random_seed=seed).plan),
                stripes[seed].perm(cluster)))
            bmaps.append(stripes[seed].block_map(cluster))
        out.append((pas, code, bmaps))
    return out


@pytest.mark.card
@pytest.mark.parametrize("nbytes", [4099, 1 << 20])
def test_batches_on_dirty_memory_on_the_card(card, nbytes):
    """A buffer-sized block filled with 0xFF and freed first, so the
    allocator hands the batch's buffer back dirty: the kernels must write
    every row they read."""
    rng = np.random.default_rng(nbytes)
    for pas, code, bmaps in _batches():
        cws = [code.encode(_bytes(rng, code.k, nbytes)) for _ in pas]
        rows = len(pas) * max(pa.num_jobs for pa in pas) * max(
            pa.num_nodes for pa in pas)
        want = dataplane.execute_plans_batch(pas, code, cws, block_of=bmaps,
                                             device="cpu")
        dirty = torch.full((rows, nbytes + (-nbytes % 4)), 0xFF,
                           dtype=torch.uint8, device=card)
        del dirty
        got = dataplane.execute_plans_batch(
            pas, code, [cw.to(card) for cw in cws], block_of=bmaps,
            device=card)
        assert got.all_verified and want.all_verified
        assert np.array_equal(got.bytes_moved, want.bytes_moved)
        for g, w in zip(got.reconstructed, want.reconstructed):
            assert g.keys() == w.keys()
            for jid in g:
                assert torch.equal(g[jid].cpu(), w[jid])
