"""The split packing kernels' plain versions (B8) against the unsplit
plain versions, on the CPU.

`pack_shard.pack_split_sharded_ref` (split B1),
`pack_split_wavefront_sharded_ref` (split B3, widths 1, 8 and 16) and
`pack_flat_words_sharded_ref` (split B2) take the config-axis inputs as
per-shard column blocks and combine each shard's partial reductions;
held here, for S in {1, 2, 3, 4, 5, 7, 8}, to `pack_split_ref`,
`pack_split_wavefront_ref` and `pack_flat_words_ref` on the same
problem with the config axis padded to lcm(32, S) as the split pads it:
`testing.kernel_cases` (both modes, reservations, the bound block with
quotas, group caps, conflicts, extreme demand, the node-axis cap) and
`testing.tie_case` (picks that tie across every shard boundary: a
column index taken from the shard instead of the solve changes the
result; mask words that straddle shards, at S = 2, 4 and 8, whose shard
widths of 48, 24 and 12 columns are not multiples of 32). A shard offset of 0 for every shard makes them fail (checked
below). No JAX: the unsplit plain versions are held to the JAX kernels
by test_torch_pack.py and test_torch_wavefront.py.

Tolerance: the flat output buffers (every output, the masks bit-packed
over the global columns) byte-identical; the replicas equal.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing
from karpenter_tpu_torch.solver import pack_shard, pack_split

SHARDS = [1, 2, 3, 4, 5, 7, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    return testing.kernel_cases(2, n_pods=300, n_types=16)


def _t(x):
    if x is None:
        return None
    if isinstance(x, list):
        return [torch.from_numpy(np.ascontiguousarray(b)) for b in x]
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(case, S):
    sa, skw, fa, fkw = testing.split_case(case, S)
    return ([_t(a) for a in sa], {k: _t(v) for k, v in skw.items()},
            [_t(a) for a in fa], {k: _t(v) for k, v in fkw.items()})


def _case(cases, which, S):
    if which == "ties-cost":
        return testing.tie_case(11, S, "cost")
    if which == "ties-ffd":
        return testing.tie_case(12, S, "ffd", quota=True)
    return cases[which]


def _sequential(case, S):
    sa, skw, fa, fkw = _inputs(case, S)
    want = pack_split.pack_flat_words_ref(*pack_split.pack_split_ref(
        *fa, max_free=case.max_free, mode=case.mode, **fkw))
    got = pack_shard.pack_split_sharded(*sa, max_free=case.max_free, mode=case.mode, **skw)
    return got, pack_shard.pack_flat_words_sharded(*got), want


@pytest.mark.parametrize("which", [0, 1, 2, 4, 7, 8, "ties-cost", "ties-ffd"])
@pytest.mark.parametrize("S", SHARDS)
def test_split_b1_and_b2_equal_the_unsplit(cases, S, which):
    case = _case(cases, which, S)
    got, flat, want = _sequential(case, S)
    assert torch.equal(flat, want), case.name
    for t in (got[0], got[2], got[3]):
        assert t.shape[0] == S and all(torch.equal(t[0], t[s]) for s in range(S))
    assert len(got[1]) == S


@pytest.mark.parametrize("which", [3, "ties-cost", "ties-ffd"])
@pytest.mark.parametrize("width", [1, 8, 16])
@pytest.mark.parametrize("S", SHARDS)
def test_split_b3_equals_the_unsplit(cases, S, width, which):
    case = _case(cases, which, S)
    sa, skw, fa, fkw = _inputs(case, S)
    want = pack_split.pack_split_wavefront_ref(
        *fa, max_free=case.max_free, mode=case.mode, width=width, **fkw)
    got = pack_shard.pack_split_wavefront_sharded(
        *sa, max_free=case.max_free, mode=case.mode, width=width, **skw)
    flat_w = pack_split.pack_flat_words_ref(want[0], want[1], want[2], want[3], want[5], want[4])
    flat_g = pack_shard.pack_split_flat_sharded(
        *sa, max_free=case.max_free, mode=case.mode, wavefront=width, **skw) if width > 1 else \
        pack_shard.pack_flat_words_sharded(got[0], got[1], got[2], got[3], got[5], got[4])
    assert torch.equal(flat_g, flat_w), case.name
    assert int(got[4][0]) == int(want[4])


def test_ties_cross_shard_boundaries():
    """The tie fixtures do what they are for: at each S the twin columns
    sit on both sides of every boundary, and the split picks the lower
    global column."""
    for S in (2, 3, 8):
        for mode in ("cost", "ffd"):
            case = testing.tie_case(11, S, mode)
            Cs = case.args[0].shape[1] // S
            alloc, price = case.args[3], case.args[11]
            for s in range(1, S):
                a, b = s * Cs - 1, s * Cs
                if mode == "cost":
                    assert price[a] / alloc[a, 0] == price[b] / alloc[b, 0]
                    assert alloc[a, 0] != alloc[b, 0]
                else:
                    assert (alloc[a] == alloc[b]).all() and price[a] == price[b]
                    assert case.kwargs["cfg_rsv"][a] != case.kwargs["cfg_rsv"][b]


@pytest.mark.parametrize("S", [2, 4, 8])
def test_mask_words_straddle_shards(S):
    """Shard widths that are not multiples of 32 (96 columns over 2, 4
    and 8 shards): the split B2 takes each bit from the shard that owns
    its column."""
    case = testing.tie_case(13, S, "cost")
    sa, skw, fa, fkw = _inputs(case, S)
    Cs = sa[0][0].shape[1]
    assert Cs % 32 != 0
    got, flat, want = _sequential(case, S)
    assert torch.equal(flat, want)
    # the masks of a shard alone do not make the words: a permuted shard
    # order changes the buffer whenever any fresh row keeps a config
    masks = got[1]
    if any(bool(m.any()) for m in masks):
        swapped = pack_shard.pack_flat_words_sharded(
            got[0], masks[1:] + masks[:1], got[2], got[3])
        assert not torch.equal(swapped, want)


def test_a_wrong_shard_offset_shows(monkeypatch):
    """Every shard's columns counted from 0 (the local index in place of
    the global one) changes the picks where ties cross boundaries."""
    orig = pack_shard._Shards.__init__

    def local_index(self, *a, **k):
        orig(self, *a, **k)
        self.c0 = [0] * self.S

    monkeypatch.setattr(pack_shard._Shards, "__init__", local_index)
    differs = 0
    for S in (2, 3, 8):
        for mode in ("cost", "ffd"):
            case = testing.tie_case(11, S, mode)
            got, flat, want = _sequential(case, S)
            differs += int(not torch.equal(flat, want))
    assert differs == 6
