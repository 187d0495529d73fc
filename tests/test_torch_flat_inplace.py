"""The flat routes' in-place layout held against the JAX package.

The port's `pack_split_flat` and `pack_probe_lanes_flat` allocate one
zeroed buffer (`pack_split.flat_layout`: the flat rows, then the mask
bytes), let the packing kernel write its assignment, tallies and stats
into the rows' regions, and pack only the mask words
(`pack_split.flat_masks`). On the CPU the wrappers run the same layout
with the plain versions (`_fill_flat_ref` writes the regions, then
`pack_flat_masks_ref`). Here those wrappers, on the same seeded inputs as
the JAX `pack_split_flat` and `pack_probe_lanes_flat` (run as the JAX
package's own tests run them, under JAX_PLATFORMS=cpu), must give the
same words, byte for byte: B1 and B3 on one lane's problem, B6's
sequential and wavefront programs on every lane.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_tpu.solver import pack as jpack
from karpenter_tpu_torch.solver import pack_split as kernels
from karpenter_tpu_torch.testing import lane_cases, one_core


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    with one_core():
        yield


@pytest.fixture(scope="module")
def case():
    return lane_cases(0, n_pods=400, n_types=40, n_lanes=6)[1]  # reservations, conflicts


def _put(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _in_buffer(rows, lay):
    # the rows are the head of one buffer of the layout's words, the mask
    # bytes behind them on 16 bytes
    storage = rows.untyped_storage()
    assert rows.data_ptr() == storage.data_ptr() and storage.nbytes() == 4 * lay["total"]
    assert rows.numel() == lay["L"] * lay["row"] and rows.shape[-1] == lay["row"]
    assert lay["masks"] % 4 == 0 and lay["masks"] >= rows.numel()


def test_pack_split_flat_in_place_identical_to_jax(case):
    # one lane's problem (lane 2's demand and live rows) on the B3 route,
    # its stats appended
    mode, wavefront = "cost", 8
    args = list(case.args)
    args[2], args[10] = args[2][2], args[10][2]
    kw = case.kwargs
    want = np.asarray(jpack.pack_split_flat(
        *[jnp.asarray(a) for a in args], max_free=case.max_free, mode=mode,
        wavefront=wavefront, **{k: None if v is None else jnp.asarray(v)
                                for k, v in kw.items()}))
    got = kernels.pack_split_flat(*[_put(a) for a in args], max_free=case.max_free, mode=mode,
                                  wavefront=wavefront, **{k: _put(v) for k, v in kw.items()})
    # a view of the route's one buffer: the row, then the mask bytes
    G, C = args[0].shape
    lay = kernels.flat_layout(1, args[7].shape[0] + case.max_free, G, case.max_free, C, True)
    _in_buffer(got, lay)
    assert want.dtype == np.uint32 and want.shape == tuple(got.shape)
    assert want.tobytes() == got.numpy().view(np.uint32).tobytes()


def test_pack_probe_lanes_flat_in_place_identical_to_jax(case):
    # every lane on B6's sequential program
    mode, wavefront = "ffd", 0
    kw = case.kwargs
    want = np.asarray(jpack.pack_probe_lanes_flat(
        *[jnp.asarray(a) for a in case.args], max_free=case.max_free, mode=mode,
        wavefront=wavefront, **{k: None if v is None else jnp.asarray(v)
                                for k, v in kw.items()}))
    got = kernels.pack_probe_lanes_flat(
        *[_put(a) for a in case.args], max_free=case.max_free, mode=mode,
        wavefront=wavefront, **{k: _put(v) for k, v in kw.items()})
    G, C = case.args[0].shape
    F = case.max_free
    lay = kernels.flat_layout(got.shape[0], case.args[7].shape[0] + F, G, F, C, False)
    _in_buffer(got, lay)
    assert want.dtype == np.uint32 and want.shape == tuple(got.shape)
    assert want.tobytes() == got.numpy().view(np.uint32).tobytes()
