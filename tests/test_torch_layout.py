"""The port's slab layout and data pipeline against the JAX package.

Shape-only: the packer's sections, leaf offsets and leaf runs key every
channel stream, so they must equal the reference's exactly for the
full-width paper MLP; the numpy data pipeline must give identical batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common.config import ModelConfig as JaxModelConfig
from repro.common.flatpack import packer_for as jax_packer_for
from repro.core import ota as jota
from repro.data import federated as jfed
from repro.data import radcom as jradcom
from repro.models.model import Model as JaxModel
from repro_torch.common.config import ModelConfig
from repro_torch.common.flatpack import packer_for
from repro_torch.common.tree import tree_flatten_with_path
from repro_torch.core import ota
from repro_torch.data import federated, radcom
from repro_torch.models.model import PAPER_MLP_DIMS, build_model


def _templates():
    m = JaxModel(JaxModelConfig(family="mlp"))
    specs = {"final": m.final_specs(), "trunk": m.trunk_specs()}
    tpl = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                       specs, is_leaf=lambda s: hasattr(s, "axes"))
    port = build_model(ModelConfig(family="mlp"))
    shapes = {"final": {k: s.shape for k, s in port.final_specs().items()},
              "trunk": {k: {kk: s.shape for kk, s in v.items()}
                        for k, v in port.trunk_specs().items()}}
    return tpl, shapes


@pytest.mark.parametrize("sections,min_rows,max_rows", [
    ("toplevel", 0, 0),      # the main path's layout
    ("tail", 0, 0),          # the two-section layout
    ("toplevel", 4096, 0),   # coalesced trunk sections
    ("toplevel", 0, 4096),   # split trunk sections
])
def test_packer_matches_reference(sections, min_rows, max_rows):
    tpl, shapes = _templates()
    jp = jax_packer_for(tpl, tail="final", sections=sections,
                        min_section_rows=min_rows, max_section_rows=max_rows)
    tp = packer_for(shapes, tail="final", sections=sections,
                    min_section_rows=min_rows, max_section_rows=max_rows)
    assert [tuple(s) for s in tp.sections] == [tuple(s) for s in jp.sections]
    assert {i: (s.offset, s.size, s.shape) for i, s in tp.slots.items()} == \
        {i: (s.offset, s.size, s.shape) for i, s in jp.slots.items()}
    assert [tuple(r) for r in tp.leaf_runs()] == \
        [tuple(r) for r in jp.leaf_runs()]
    assert (tp.tail_name, tp.tail_len, tp.head_len, tp.size, tp.order) == \
        (jp.tail_name, jp.tail_len, jp.head_len, jp.size, jp.order)
    assert ota.packed_section_folds(tp) == jota.packed_section_folds(jp)


def test_leaf_order_is_jax_flatten_order():
    tpl, shapes = _templates()
    want = [tuple(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tpl)[0]]
    assert [p for p, _ in tree_flatten_with_path(shapes)] == want
    assert want[0] == ("final", "b") and want[2] == ("trunk", "fc0", "b")
    assert len(PAPER_MLP_DIMS) == 6


def test_radcom_and_batches_identical():
    cfg_j = jradcom.RadComConfig(n_points=1500)
    cfg_t = radcom.RadComConfig(n_points=1500)
    dj, dt = jradcom.make_radcom_dataset(cfg_j), radcom.make_radcom_dataset(cfg_t)
    assert sorted(dj) == sorted(dt)
    for k in dj:
        assert np.array_equal(dj[k], dt[k]), k
    pj = jradcom.client_partition(dj, 3, 2, seed=4)
    pt = radcom.client_partition(dt, 3, 2, seed=4)
    bj = jfed.FederatedBatcher(pj, 8, seed=5)
    bt = federated.FederatedBatcher(pt, 8, seed=5)
    assert bj.tasks() == bt.tasks()
    for _ in range(2):
        (xj, yj), (xt, yt) = bj.next_stacked(), bt.next_stacked()
        assert xt.shape == (3, 2, 8, 256) and xt.dtype == np.float32
        assert np.array_equal(xj, xt) and np.array_equal(yj, yt)
