"""The port's slab layout of every architecture at full size, and the
packer's tail views, against the reference's ``repro.common.flatpack``.

For all eleven ``ARCH_IDS`` at their full published sizes (no weight
drawn: the port's template is ``abstract_params``' meta tensors, the
reference's ``jax.eval_shape`` over its ``init_params``), the port's
``TreePacker`` equals the reference's in the "tail" and "toplevel"
layouts and with ``max_section_rows`` splitting the stacks: leaf paths,
sections, slots, stream folds, ``leaf_runs`` and ``chunk_leaf_map``.
``tail_slice`` and ``unpack_tail`` equal the reference's on a small tree
(no dtype cast: a bool mask stays bool; a packer without a tail refuses),
and a zero-size leaf keeps its chunk (``tests/test_layout_tune.py``'s
regression).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.flatpack import TreePacker as JPacker
from repro.configs import get_config as jax_config
from repro.core.ota import packed_section_folds as jax_folds
from repro.models.model import build_model as jax_build_model
from repro.models.params import init_params as jax_init_params
from repro_torch.common.flatpack import TreePacker
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.ota import packed_section_folds
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_params

SPLIT_ROWS = 4096          # splits most real layer stacks
CHUNK = 1 << 24            # a chunk-driven kernel's chunk, in entries
LAYOUTS = {"tail": dict(sections="tail"),
           "toplevel": dict(sections="toplevel"),
           "split": dict(sections="toplevel", max_section_rows=SPLIT_ROWS)}


def _jax_template(arch):
    model = jax_build_model(jax_config(arch))

    def init(key):
        return {"final": jax_init_params(model.final_specs(), key),
                "trunk": jax_init_params(model.trunk_specs(), key)}
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _template(arch):
    model = build_model(get_config(arch))
    return abstract_params({"final": model.final_specs(),
                            "trunk": model.trunk_specs()})


def _paths(jpk):
    return [tuple(k.key for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                jpk.treedef.unflatten(list(range(len(jpk.slots)))))[0]]


def _layout(pk, folds):
    return {"sections": [tuple(s) for s in pk.sections],
            "slots": {i: (s.offset, s.size, tuple(s.shape))
                      for i, s in pk.slots.items()},
            "order": list(pk.order), "head_len": pk.head_len,
            "tail_len": pk.tail_len, "size": pk.size,
            "folds": folds(pk),
            "runs": [tuple(r) for r in pk.leaf_runs()],
            "chunks": {s: [(j, [tuple(r) for r in runs]) for j, runs in per]
                       for s, per in pk.chunk_leaf_map(CHUNK).items()}}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zoo_layout_matches_reference(arch):
    jt, tt = _jax_template(arch), _template(arch)
    for name, kw in LAYOUTS.items():
        jpk = JPacker(jt, tail="final", **kw)
        pk = TreePacker(tt, tail="final", **kw)
        assert pk.paths == _paths(jpk), (arch, name)
        assert _layout(pk, packed_section_folds) == \
            _layout(jpk, jax_folds), (arch, name)


def _small():
    r = np.random.default_rng(0)
    tree = {"final": {"b": r.standard_normal((3,)).astype(np.float32),
                      "w": r.standard_normal((4, 3)).astype(np.float32)},
            "trunk": {"fc0": {"w": r.standard_normal((5, 4)).astype(
                np.float32), "empty": np.zeros((0,), np.float32)}}}
    return tree


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tail_views_match_reference(layout):
    kw = dict(LAYOUTS[layout])
    kw.pop("max_section_rows", None)
    tree = _small()
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    jpk = JPacker(jtree, tail="final", **kw)
    pk = TreePacker(ttree, tail="final", **kw)
    jslab = jpk.pack(jtree)
    slab = pk.pack(ttree)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jslab))
    jtail = jpk.tail_slice(jslab)
    tail = pk.tail_slice(slab)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    want = jpk.unpack_tail(jtail)
    got = pk.unpack_tail(tail)
    assert sorted(got) == sorted(want) == ["b", "w"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # batched, and no dtype cast: a bool mask stays bool
    mask = torch.stack([tail, -tail]) > 0
    got_m = pk.unpack_tail(mask)
    want_m = jpk.unpack_tail(jnp.stack([jtail, -jtail]) > 0)
    for k in want_m:
        assert got_m[k].dtype == torch.bool and got_m[k].shape == \
            want_m[k].shape
        np.testing.assert_array_equal(got_m[k].numpy(),
                                      np.asarray(want_m[k]))


def test_unpack_tail_refuses_without_a_tail():
    pk = TreePacker(jax.tree.map(torch.from_numpy, _small()), tail=None)
    with pytest.raises(ValueError, match="tail=None"):
        pk.unpack_tail(torch.zeros(8))
    jpk = JPacker(jax.tree.map(jnp.asarray, _small()), tail=None)
    with pytest.raises(ValueError, match="tail=None"):
        jpk.unpack_tail(jnp.zeros(8))


def test_chunk_leaf_map_keeps_zero_size_leaves():
    """The port's counterpart of ``tests/test_layout_tune.py``'s
    regression: a zero-size leaf stays in the chunk at its offset."""
    template = {"final": {"w": torch.empty((4, 4), device="meta")},
                "trunk": {"fc0": {"w": torch.empty((8, 8), device="meta"),
                                  "empty": torch.empty((0,), device="meta"),
                                  "b": torch.empty((8,), device="meta")}}}
    pk = TreePacker(template, tail="final", sections="toplevel")
    seen = {r.leaf for per in pk.chunk_leaf_map(131072).values()
            for _, runs in per for r in runs}
    assert seen == set(range(len(pk.slots)))
    jt = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                     jnp.float32), template)
    jpk = JPacker(jt, tail="final", sections="toplevel")
    for chunk in (4, 131072):
        assert _layout(pk, packed_section_folds)["runs"] == \
            _layout(jpk, jax_folds)["runs"]
        assert {s: [(j, [tuple(r) for r in runs]) for j, runs in per]
                for s, per in pk.chunk_leaf_map(chunk).items()} == \
            {s: [(j, [tuple(r) for r in runs]) for j, runs in per]
             for s, per in jpk.chunk_leaf_map(chunk).items()}
