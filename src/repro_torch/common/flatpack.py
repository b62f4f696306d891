"""The slab layout of the shared model: sections, offsets and leaf runs.

Port of the layout half of ``repro.common.flatpack``. The channel draws
one chunk-quantized bit stream per section (``repro_torch.core.ota``), so
this layout fixes which random bits every parameter entry sees; it must
match the reference bit for bit. The client-folded channel reads each
gradient leaf in place against its ``LeafRun`` (its section and the
offset of its storage in that section's stream); the packed engine
(``repro_torch.core.ota.ota_aggregate_packed``) copies the tree into a
(*batch, P) float32 slab with ``pack`` and back with ``unpack``.

Layouts (``sections``):

* ``"tail"``: two sections, head leaves butt-packed in flatten order and
  the ``tail`` subtree (the last shared layer, ω̃) last, each padded to
  ``ROW_QUANTUM``;
* ``"toplevel"``: one section per depth-2 path prefix (``trunk/fc0``,
  ...), the tail last, every leaf ``ROW_QUANTUM``-aligned in its section.
  ``min_section_rows`` merges adjacent small trunk sections and
  ``max_section_rows`` splits large ones at leaf boundaries; neither moves
  a leaf, only the partition (and so the stream folds) changes.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.tree import (
    tree_flatten_with_path, tree_leaves, tree_unflatten,
)
from repro_torch.kernels.slab import LANE, ROW_QUANTUM, round_up


class LeafSlot(NamedTuple):
    offset: int                # start index into the (P,) slab
    size: int                  # element count
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32   # the template leaf's dtype


class Section(NamedTuple):
    """One ROW_QUANTUM-aligned region of the slab, with its own streams."""
    name: str                  # section key ("" = head catch-all)
    index: int                 # position, selects the stream fold
    start: int                 # slab offset (ROW_QUANTUM-aligned)
    length: int                # padded length (ROW_QUANTUM multiple)
    leaf_indices: Tuple[int, ...]   # flatten-order leaf ids, pack order


class LeafRun(NamedTuple):
    """Where one leaf's entries sit in its section's bit stream:
    elements [offset, offset + size) of section ``section``."""
    leaf: int
    section: int
    offset: int
    size: int


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _dtype(leaf) -> torch.dtype:
    """A tensor leaf's dtype; a shape-tuple leaf stands for float32."""
    return leaf.dtype if isinstance(leaf, torch.Tensor) else torch.float32


def _section_key(path, tail: Optional[str]) -> Optional[str]:
    """The tail key, or the depth-2 path prefix: one section per layer
    stack (``trunk/fc0``), not per top-level container."""
    if tail is not None and path and path[0] == tail:
        return tail
    if not path:
        return None
    return "/".join(str(p) for p in path[:2])


class TreePacker:
    """Static layout of a parameter tree (nested dicts whose leaves are
    tensors or shape tuples) on the lane-aligned (P,) slab."""

    def __init__(self, template, tail: Optional[str] = "final",
                 sections: str = "tail", min_section_rows: int = 0,
                 max_section_rows: int = 0):
        if sections not in ("tail", "toplevel"):
            raise ValueError(
                f"sections must be 'tail' or 'toplevel', got {sections!r}")
        min_section_rows = int(min_section_rows)
        max_section_rows = int(max_section_rows)
        if min_section_rows < 0 or max_section_rows < 0:
            raise ValueError("min/max_section_rows must be >= 0")
        if sections == "tail" and (min_section_rows or max_section_rows):
            raise ValueError(
                "min/max_section_rows require sections='toplevel': the "
                "two-section layout has no trunk sections to merge or split")
        if max_section_rows and max_section_rows < min_section_rows:
            raise ValueError(
                f"max_section_rows ({max_section_rows}) < min_section_rows "
                f"({min_section_rows}): contradictory layout")
        self.min_section_rows = min_section_rows
        self.max_section_rows = max_section_rows
        paths_leaves = tree_flatten_with_path(template)
        self.paths = [p for p, _ in paths_leaves]
        self.tail_name = tail
        self.layout = sections

        def in_tail(path):
            return tail is not None and bool(path) and path[0] == tail

        head_idx = [i for i, (p, _) in enumerate(paths_leaves)
                    if not in_tail(p)]
        tail_idx = [i for i, (p, _) in enumerate(paths_leaves) if in_tail(p)]
        self.order: List[int] = head_idx + tail_idx
        self.tail_indices = tail_idx
        self.slots: Dict[int, LeafSlot] = {}
        self.sections: List[Section] = []

        def _slot(i, off):
            leaf = paths_leaves[i][1]
            shape = _shape(leaf)
            size = 1
            for d in shape:
                size *= d
            self.slots[i] = LeafSlot(off, size, shape, _dtype(leaf))
            return size

        if sections == "tail":
            off = 0
            for i in head_idx:
                off += _slot(i, off)
            self.head_len = round_up(off, ROW_QUANTUM)
            off = self.head_len
            for i in tail_idx:
                off += _slot(i, off)
            self.tail_len = round_up(off - self.head_len, ROW_QUANTUM)
            if head_idx:
                self.sections.append(Section("", 0, 0, self.head_len,
                                             tuple(head_idx)))
            if tail_idx:
                self.sections.append(
                    Section(tail, len(self.sections), self.head_len,
                            self.tail_len, tuple(tail_idx)))
        else:
            self._toplevel(paths_leaves, head_idx + tail_idx, tail, _slot)

        self.size = self.head_len + self.tail_len       # P, lane-aligned
        if self.size == 0:
            raise ValueError("cannot pack an empty tree")
        self.n_rows = self.size // LANE

    def _toplevel(self, paths_leaves, idx, tail, _slot):
        names: List[Optional[str]] = []
        groups: Dict[Optional[str], List[int]] = {}
        for i in idx:
            name = _section_key(paths_leaves[i][0], tail)
            if name not in groups:
                groups[name] = []
                names.append(name)
            groups[name].append(i)
        if tail is not None and tail in names:   # tail always last
            names.remove(tail)
            names.append(tail)
        # every leaf and every group starts ROW_QUANTUM-aligned, so the
        # merging and splitting below never move a leaf
        off = 0
        atoms = []   # (name, start, length, leaf_indices, is_tail)
        for name in names:
            start = off
            for i in groups[name]:
                off = start + round_up(off - start, ROW_QUANTUM)
                off += _slot(i, off)
            length = round_up(off - start, ROW_QUANTUM)
            off = start + length
            atoms.append(("" if name is None else name, start, length,
                          tuple(groups[name]),
                          tail is not None and name == tail))
        # merge adjacent sub-threshold trunk groups; a trailing remainder
        # folds into the previous trunk section; the tail is never merged
        threshold = self.min_section_rows * LANE
        merged: List[List[Any]] = []   # [names, start, length, leaves]
        open_grp: Optional[List[Any]] = None
        for name, start, length, leaf_idx, is_tail in atoms:
            if is_tail:
                continue
            if open_grp is None:
                open_grp = [[name], start, length, list(leaf_idx)]
            else:
                open_grp[0].append(name)
                open_grp[2] += length
                open_grp[3].extend(leaf_idx)
            if open_grp[2] >= threshold:
                merged.append(open_grp)
                open_grp = None
        if open_grp is not None:
            if merged:
                merged[-1][0].extend(open_grp[0])
                merged[-1][2] += open_grp[2]
                merged[-1][3].extend(open_grp[3])
            else:
                merged.append(open_grp)
        # split over-cap trunk sections at leaf boundaries; a single leaf
        # longer than the cap stays one section (runs never straddle)
        if self.max_section_rows:
            cap = self.max_section_rows * LANE
            split: List[List[Any]] = []
            for sec_names, start, length, leaf_list in merged:
                if length <= cap:
                    split.append([sec_names, start, length, leaf_list])
                    continue
                base = "+".join(sec_names)
                end = start + length
                pieces: List[Tuple[int, List[int]]] = []
                p_start, p_leaves = start, []
                for i in leaf_list:
                    slot = self.slots[i]
                    if p_leaves and round_up(
                            slot.offset + slot.size - p_start,
                            ROW_QUANTUM) > cap:
                        pieces.append((p_start, p_leaves))
                        p_start, p_leaves = slot.offset, []
                    p_leaves.append(i)
                pieces.append((p_start, p_leaves))
                for k, (ps, pl) in enumerate(pieces):
                    pe = pieces[k + 1][0] if k + 1 < len(pieces) else end
                    split.append([[f"{base}[{k}]"], ps, pe - ps, pl])
            merged = split
        merged.extend([[a[0]], a[1], a[2], list(a[3])] for a in atoms if a[4])
        self.order = []
        for sec_names, start, length, leaf_list in merged:
            self.sections.append(
                Section("+".join(sec_names), len(self.sections), start,
                        length, tuple(leaf_list)))
            self.order.extend(leaf_list)
        self.tail_len = (self.sections[-1].length
                         if tail is not None and tail in names else 0)
        self.head_len = off - self.tail_len

    def leaf_runs(self) -> List[LeafRun]:
        """One entry per leaf in pack order: the (section, offset, size)
        stream slice its storage occupies."""
        runs = []
        for sec in self.sections:
            for i in sec.leaf_indices:
                slot = self.slots[i]
                runs.append(LeafRun(i, sec.index, slot.offset - sec.start,
                                    slot.size))
        return runs

    def peak_section_rows(self) -> int:
        """Largest section in LANE-wide rows: the peak live stream
        footprint of the sectioned engine."""
        return max(sec.length for sec in self.sections) // LANE

    def chunk_leaf_map(self, chunk: int
                       ) -> Dict[int, List[Tuple[int, List[LeafRun]]]]:
        """section index -> [(chunk j, the leaf runs intersecting
        [j·chunk, (j+1)·chunk)), ...] in chunk order: the inverse view of
        ``leaf_runs`` that a chunk-driven kernel walks. A zero-size run
        belongs to the chunk at its offset."""
        out: Dict[int, Dict[int, List[LeafRun]]] = {}
        for run in self.leaf_runs():
            per = out.setdefault(run.section, {})
            j0 = run.offset // chunk
            j1 = (run.offset + run.size - 1) // chunk if run.size else j0
            for j in range(j0, j1 + 1):
                per.setdefault(j, []).append(run)
        return {s: sorted(d.items()) for s, d in out.items()}

    def pack(self, tree) -> torch.Tensor:
        """Tree -> (*batch, P) float32 slab; section padding stays zero.
        Leaves may carry identical leading batch axes (the (C,) cluster
        axis of weighted gradients), which the slab keeps."""
        leaves = tree_leaves(tree)
        i0 = self.order[0]
        nb = leaves[i0].dim() - len(self.slots[i0].shape)
        batch = tuple(leaves[i0].shape[:nb])
        slab = torch.zeros(batch + (self.size,), dtype=torch.float32,
                           device=leaves[i0].device)
        for i in self.order:
            slot = self.slots[i]
            slab[..., slot.offset:slot.offset + slot.size] = (
                leaves[i].reshape(batch + (-1,)))
        return slab

    def unpack(self, slab: torch.Tensor):
        """(*batch, P) slab -> tree of (*batch, *shape) leaves, each in its
        slot's dtype."""
        batch = tuple(slab.shape[:-1])
        leaves = [None] * len(self.slots)
        for i, slot in self.slots.items():
            piece = slab[..., slot.offset:slot.offset + slot.size]
            leaves[i] = piece.reshape(batch + slot.shape).to(slot.dtype)
        return _tree_of(self.paths, leaves)

    def tail_slice(self, slab: torch.Tensor) -> torch.Tensor:
        """The contiguous last-shared-layer tail of a (..., P) slab (a
        view)."""
        return slab[..., self.head_len:self.size]

    def unpack_tail(self, tail_slab: torch.Tensor):
        """(..., tail_len) tail slice -> the ``tail`` subtree, leaves
        (..., *shape) in the slice's dtype (no cast: masks stay bool)."""
        if self.tail_name is None:
            raise ValueError("this packer was built with tail=None: it has "
                             "no tail section to unpack")
        batch = tuple(tail_slab.shape[:-1])
        leaves = []
        for i in self.tail_indices:
            slot = self.slots[i]
            off = slot.offset - self.head_len
            leaves.append(tail_slab[..., off:off + slot.size].reshape(
                batch + slot.shape))
        return _tree_of([self.paths[i][1:] for i in self.tail_indices],
                        leaves)


def _tree_of(paths, leaves):
    """The nested dicts holding ``leaves`` at ``paths`` (flatten order)."""
    template: Dict[str, Any] = {}
    for path in paths:
        node = template
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = None
    return tree_unflatten(template, leaves)


def check_tree_matches_packer(packer: TreePacker, tree, what: str,
                              batch_ndim: int = 0) -> None:
    """Raise a readable error when ``tree``'s leaf paths or shapes differ
    from the packer's template. ``batch_ndim`` lets every leaf carry that
    many identical leading axes (the (C, N) axes of raw gradients)."""
    paths_leaves = tree_flatten_with_path(tree)
    batch = None
    for i, (path, leaf) in enumerate(paths_leaves):
        shape = tuple(leaf.shape)
        if i >= len(packer.paths) or path != packer.paths[i]:
            exp = packer.paths[i] if i < len(packer.paths) else "nothing"
            raise ValueError(f"{what}: leaf {i} is {'/'.join(path)}, the "
                             f"packer template expects {exp}")
        if batch is None:
            batch = shape[:batch_ndim]
        if (shape[:batch_ndim] != batch
                or shape[batch_ndim:] != packer.slots[i].shape):
            raise ValueError(
                f"{what}: leaf {'/'.join(path)} has shape {shape}, expected "
                f"{batch} + {packer.slots[i].shape}")
    if len(paths_leaves) != len(packer.paths):
        raise ValueError(f"{what}: {len(paths_leaves)} leaves, the packer "
                         f"template has {len(packer.paths)}")


_PACKER_CACHE: Dict[Any, TreePacker] = {}


def packer_for(tree, tail: Optional[str] = "final", sections: str = "tail",
               min_section_rows: int = 0,
               max_section_rows: int = 0) -> TreePacker:
    """Cached ``TreePacker`` for ``tree``'s paths and leaf shapes."""
    paths_leaves = tree_flatten_with_path(tree)
    key = (tuple((p, _shape(l), _dtype(l)) for p, l in paths_leaves), tail,
           sections, int(min_section_rows), int(max_section_rows))
    packer = _PACKER_CACHE.get(key)
    if packer is None:
        # storage-free stand-ins keep shape and dtype, not the data
        template = _tree_of(
            [p for p, _ in paths_leaves],
            [torch.empty(_shape(l), dtype=_dtype(l), device="meta")
             for _, l in paths_leaves])
        packer = TreePacker(template, tail, sections=sections,
                            min_section_rows=min_section_rows,
                            max_section_rows=max_section_rows)
        _PACKER_CACHE[key] = packer
    return packer
