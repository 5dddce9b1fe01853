"""Dremel-style shredding with Lance-convention repetition/definition levels.

``shred`` converts a (possibly nested) :class:`repro_torch.core.arrays.Array` into
one :class:`ShreddedLeaf` per primitive leaf.  ``unshred`` is the exact
inverse.  These leaves are what the structural encodings
(mini-block / full-zip / parquet-like) physically serialize.

Level conventions (matching the paper, Fig. 6):

* **Repetition**: ``rep == 0`` continues the innermost list; ``rep == k``
  starts a new list at the k-th level counting **outward from the innermost
  list** (so a new top-level record has ``rep == max_rep``).  Columns without
  list ancestors have ``max_rep == 0`` and carry no repetition stream.
* **Definition**: ``def == 0`` is a fully-valid leaf value.  Codes count
  termination sites from the innermost level outward: for
  ``Struct<List<String>>`` the codes are ``1 = null item``, ``2 = empty
  list``, ``3 = null list``, ``4 = null struct`` — exactly the paper's
  example.  Values are stored **sparsely** (entries with ``def != 0`` occupy
  no slot in the values array); the *encodings* decide whether to re-insert
  filler (dense full-zip) or not (mini-block / parquet pages).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List as PyList, Optional, Tuple

import numpy as np

from . import arrays as A
from . import types as T

__all__ = ["ShreddedLeaf", "shred", "unshred", "leaf_paths"]


@dataclasses.dataclass
class ShreddedLeaf:
    """One shredded leaf column."""

    path: Tuple[str, ...]  # struct field names from root to leaf ("" for non-struct hops)
    type_path: Tuple[T.DataType, ...]  # nodes root..leaf (structs/lists/leaf)
    leaf_type: T.DataType  # Primitive / FixedSizeList / Utf8 / Binary
    rep: Optional[np.ndarray]  # uint8[n_entries] lance-convention, None if max_rep == 0
    defs: Optional[np.ndarray]  # uint8[n_entries], None if max_def == 0
    values: A.Array  # sparse leaf values (non-null entries only), non-nullable type
    n_entries: int
    max_rep: int
    max_def: int
    # def-code tables (static per type path)
    def_meanings: Dict[int, str]
    # code assigned to "null item" at the leaf (0 if leaf non-nullable)
    null_item_code: int
    # number of top-level rows this leaf was shredded from
    n_rows: int

    @property
    def has_lists(self) -> bool:
        return self.max_rep > 0


# ---------------------------------------------------------------------------
# Path discovery & def-code assignment
# ---------------------------------------------------------------------------


def leaf_paths(typ: T.DataType) -> PyList[Tuple[Tuple[str, ...], Tuple[T.DataType, ...]]]:
    """Enumerate (field-name path, type path) for every leaf of ``typ``.

    FixedSizeList is a leaf (the paper treats primitive FSL as primitive).
    """
    out: PyList[Tuple[Tuple[str, ...], Tuple[T.DataType, ...]]] = []

    def walk(node: T.DataType, names: Tuple[str, ...], nodes: Tuple[T.DataType, ...]):
        nodes = nodes + (node,)
        if isinstance(node, T.Struct):
            if not node.fields:
                raise ValueError("empty struct cannot be shredded")
            for fname, ftyp in node.fields:
                walk(ftyp, names + (fname,), nodes)
        elif isinstance(node, T.List):
            walk(node.child, names, nodes)
        else:
            out.append((names, nodes))

    walk(typ, (), ())
    return out


def _def_codes(type_path: Tuple[T.DataType, ...]):
    """Assign def codes for a leaf path.

    Returns (codes, meanings, max_def, null_item_code) where ``codes`` maps
    (node_index_in_path, event) -> code; event in {"null_item", "empty",
    "null_list", "null_struct"}.
    """
    codes: Dict[Tuple[int, str], int] = {}
    meanings: Dict[int, str] = {0: "valid"}
    nxt = 1
    # walk leaf -> root
    for i in range(len(type_path) - 1, -1, -1):
        node = type_path[i]
        is_leaf = i == len(type_path) - 1
        if is_leaf:
            if node.nullable:
                codes[(i, "null_item")] = nxt
                meanings[nxt] = "null_item"
                nxt += 1
        elif isinstance(node, T.List):
            codes[(i, "empty")] = nxt
            meanings[nxt] = f"empty_list@{i}"
            nxt += 1
            if node.nullable:
                codes[(i, "null_list")] = nxt
                meanings[nxt] = f"null_list@{i}"
                nxt += 1
        elif isinstance(node, T.Struct):
            if node.nullable:
                codes[(i, "null_struct")] = nxt
                meanings[nxt] = f"null_struct@{i}"
                nxt += 1
        else:  # pragma: no cover - interior nodes are Struct/List only
            raise TypeError(node)
    max_def = nxt - 1
    null_item = codes.get((len(type_path) - 1, "null_item"), 0)
    return codes, meanings, max_def, null_item


# ---------------------------------------------------------------------------
# Shredding (vectorized walk)
# ---------------------------------------------------------------------------


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    np.cumsum(x[:-1], out=out[1:])
    return out


def shred(arr: A.Array) -> PyList[ShreddedLeaf]:
    """Shred a nested array into leaf columns."""
    leaves = []
    for names, type_path in leaf_paths(arr.type):
        leaves.append(_shred_leaf(arr, names, type_path))
    return leaves


def _shred_leaf(arr: A.Array, names: Tuple[str, ...], type_path) -> ShreddedLeaf:
    codes, meanings, max_def, null_item = _def_codes(type_path)
    # dremel depth (1-based among List nodes, from the top) for each List node
    list_nodes = [i for i, n in enumerate(type_path) if isinstance(n, T.List)]
    max_rep = len(list_nodes)
    dremel_depth = {node_i: d + 1 for d, node_i in enumerate(list_nodes)}

    n = len(arr)
    idx = np.arange(n, dtype=np.int64)
    rep = np.zeros(n, dtype=np.uint8)  # dremel convention during the walk
    defs = np.zeros(n, dtype=np.uint8)

    node_arr: A.Array = arr
    name_cursor = 0
    for node_i, node in enumerate(type_path):
        is_leaf = node_i == len(type_path) - 1
        if is_leaf:
            live = idx >= 0
            leaf_valid = np.zeros(len(idx), dtype=bool)
            leaf_valid[live] = node_arr.validity[idx[live]]
            if node.nullable:
                null_mask = live & ~leaf_valid
                defs[null_mask] = codes[(node_i, "null_item")]
            else:
                assert bool(np.all(leaf_valid[live])), "null in non-nullable leaf"
            take_idx = idx[live & leaf_valid]
            values = node_arr.take(take_idx)
            values.type = values.type.with_nullable(False)
            values.validity = np.ones(len(take_idx), dtype=bool)
            break
        if isinstance(node, T.Struct):
            live = idx >= 0
            valid = np.zeros(len(idx), dtype=bool)
            valid[live] = node_arr.validity[idx[live]]
            if node.nullable:
                null_mask = live & ~valid
                defs[null_mask] = codes[(node_i, "null_struct")]
                idx = np.where(null_mask, -1, idx)
            else:
                assert bool(np.all(valid[live])), "null in non-nullable struct"
            node_arr = node_arr.field(names[name_cursor])
            name_cursor += 1
        elif isinstance(node, T.List):
            d = dremel_depth[node_i]
            live = idx >= 0
            valid = np.zeros(len(idx), dtype=bool)
            valid[live] = node_arr.validity[idx[live]]
            safe_idx = np.where(live, idx, 0)
            diffs = node_arr.offsets[1:] - node_arr.offsets[:-1]
            if len(diffs):
                lengths = diffs[safe_idx]
            else:  # node has zero rows (everything terminated above)
                lengths = np.zeros(len(idx), dtype=np.int64)
            lengths = np.where(live & valid, lengths, 0)

            if node.nullable:
                null_mask = live & ~valid
                defs[null_mask] = codes[(node_i, "null_list")]
            else:
                assert bool(np.all(valid[live])), "null in non-nullable list"
            empty_mask = live & valid & (lengths == 0)
            defs[empty_mask] = codes[(node_i, "empty")]

            expand = live & valid & (lengths > 0)
            counts = np.where(expand, lengths, 1)
            starts = _exclusive_cumsum(counts)
            new_m = int(counts.sum())
            # rep: inherit for first element of each group, ``d`` for the rest
            new_rep = np.repeat(rep, counts)
            is_first = np.zeros(new_m, dtype=bool)
            is_first[starts] = True
            new_rep[~is_first] = d
            # defs: carry (live expanded entries keep 0 and get set later)
            new_def = np.repeat(defs, counts)
            # idx: child offsets for expanded; -1 otherwise
            local = np.arange(new_m, dtype=np.int64) - np.repeat(starts, counts)
            base_offs = node_arr.offsets[:-1]
            base_vals = (base_offs[safe_idx] if len(base_offs)
                         else np.zeros(len(idx), dtype=np.int64))
            child_base = np.repeat(np.where(expand, base_vals, -1), counts)
            new_idx = np.where(child_base >= 0, child_base + local, -1)
            idx, rep, defs = new_idx, new_rep, new_def
            node_arr = node_arr.child
        else:  # pragma: no cover
            raise TypeError(node)

    # Convert dremel rep -> lance rep: lance = number of innermost list levels
    # restarted.  dremel r == 0 restarts all; r == depth j restarts levels
    # deeper than j, i.e. (max_rep - j) innermost levels.
    if max_rep > 0:
        lance_rep = (max_rep - rep).astype(np.uint8)
    else:
        lance_rep = None

    leaf_type = type_path[-1]
    return ShreddedLeaf(
        path=names,
        type_path=tuple(type_path),
        leaf_type=leaf_type,
        rep=lance_rep,
        defs=defs if max_def > 0 else None,
        values=values,
        n_entries=len(idx),
        max_rep=max_rep,
        max_def=max_def,
        def_meanings=meanings,
        null_item_code=null_item,
        n_rows=n,
    )


# ---------------------------------------------------------------------------
# Unshredding (inverse)
# ---------------------------------------------------------------------------


def unshred(leaves: PyList[ShreddedLeaf], root_type: T.DataType) -> A.Array:
    """Reassemble a nested array from its shredded leaves."""
    projections = [(_unshred_leaf(leaf), leaf.path) for leaf in leaves]
    return _merge(root_type, projections)


def _unshred_leaf(leaf: ShreddedLeaf) -> A.Array:
    """Reconstruct one leaf as a 'projection' array: the original type path
    with every Struct level narrowed to the single traversed field."""
    codes, _, _, _ = _def_codes(leaf.type_path)
    defs = (
        leaf.defs
        if leaf.defs is not None
        else np.zeros(leaf.n_entries, dtype=np.uint8)
    )
    rep = (
        leaf.rep
        if leaf.rep is not None
        else np.full(leaf.n_entries, 0, dtype=np.uint8)
    )
    return _build(
        leaf, leaf.type_path, 0, np.arange(leaf.n_entries), defs, rep, leaf.max_rep
    )


def _slots(rep_vals: np.ndarray, slot_level: int):
    """Group an entry run into slots: a new slot starts wherever the entry
    restarts list level ``slot_level`` or any outer level."""
    starts = rep_vals >= slot_level
    if len(starts) > 0:
        starts = starts.copy()
        starts[0] = True
    seg = np.cumsum(starts) - 1  # slot id per entry
    n_slots = int(seg[-1] + 1) if len(starts) else 0
    first_of_slot = np.nonzero(starts)[0]
    return starts, seg, n_slots, first_of_slot


def _build(
    leaf: ShreddedLeaf,
    type_path,
    node_i: int,
    entries: np.ndarray,  # indices into the global entry stream handled here
    defs: np.ndarray,
    rep: np.ndarray,
    slot_level: int,  # entries with rep >= slot_level begin a new slot here
) -> A.Array:
    node = type_path[node_i]
    is_leaf = node_i == len(type_path) - 1
    codes, _, _, _ = _def_codes(type_path)
    d = defs[entries]

    if is_leaf:
        # Entries reaching the leaf are either valid values (def == 0), null
        # items, or entries terminated at an enclosing *struct* level (which
        # still occupy a slot in the child arrays, Arrow-style).  Entries
        # terminated at list levels were consumed by the list builders above.
        valid = d == 0
        # map valid entries to consecutive value slots -- the value array is
        # sparse & ordered, so slot = rank of the entry among valid entries of
        # the *whole* stream.  Compute global ranks once.
        global_valid = (
            (leaf.defs == 0) if leaf.defs is not None else np.ones(leaf.n_entries, bool)
        )
        ranks = np.cumsum(global_valid) - 1
        out_n = len(entries)
        validity = valid.copy()
        take = ranks[entries[valid]]
        vals = leaf.values.take(take)
        return _scatter_leaf(leaf.leaf_type, out_n, validity, valid, vals)

    if isinstance(node, T.Struct):
        null_code = codes.get((node_i, "null_struct"), None)
        r = rep[entries]
        starts, seg, n_slots, first_of_slot = _slots(r, slot_level)
        d_first = d[first_of_slot] if n_slots else np.zeros(0, dtype=d.dtype)
        is_null = (
            (d_first == null_code) if null_code is not None else np.zeros(n_slots, bool)
        )
        # termination ABOVE this struct also yields an (invalid) slot here
        if null_code is not None:
            slot_above = d_first > null_code
        else:
            # codes above this struct are those > every code at/below it; the
            # largest code at/below is the max over codes of deeper nodes.
            below = [c for (ni, _), c in codes.items() if ni >= node_i]
            slot_above = d_first > max(below) if below else np.zeros(n_slots, bool)
        # Children see the SAME entries and the SAME slot structure (struct
        # does not expand); entries null at this struct still occupy one slot
        # below (Arrow keeps child slots for null struct rows).
        child = _build(leaf, type_path, node_i + 1, entries, defs, rep, slot_level)
        name = leaf.path[sum(1 for t in type_path[:node_i] if isinstance(t, T.Struct))]
        validity = ~(is_null | slot_above)
        typ = T.Struct(((name, child.type),), node.nullable)
        return A.StructArray(typ, validity, ((name, child),))

    if isinstance(node, T.List):
        level = slot_level  # this list's lance level (innermost == 1)
        empty_code = codes[(node_i, "empty")]
        null_code = codes.get((node_i, "null_list"), None)
        r = rep[entries]
        starts, seg, n_slots, first_of_slot = _slots(r, level)
        d_first = d[first_of_slot] if n_slots else np.zeros(0, dtype=d.dtype)
        slot_is_null = (
            (d_first == null_code) if null_code is not None else np.zeros(n_slots, bool)
        )
        slot_is_empty = d_first == empty_code
        # termination ABOVE this list (def codes assigned later in leaf->root
        # order are strictly larger than this list's codes)
        above_threshold = max(empty_code, null_code or 0)
        slot_above = d_first > above_threshold
        element_slot = ~(slot_is_null | slot_is_empty | slot_above)
        # element entries: those in element slots
        entry_is_element = element_slot[seg]
        child_entries = entries[entry_is_element]
        # This list's lengths count CHILD SLOTS (e.g. inner lists), not raw
        # entries: a child slot starts where rep restarts level-1 or outer.
        child_starts = rep[child_entries] >= (level - 1)
        lengths = np.bincount(
            seg[entry_is_element][child_starts], minlength=n_slots
        ).astype(np.int64)
        offsets = np.zeros(n_slots + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        child = _build(
            leaf, type_path, node_i + 1, child_entries, defs, rep, level - 1
        )
        validity = ~(slot_is_null | slot_above)
        return A.ListArray(T.List(child.type, node.nullable), validity, offsets, child)

    raise TypeError(node)  # pragma: no cover


def _scatter_leaf(leaf_type: T.DataType, out_n: int, validity: np.ndarray, valid_mask: np.ndarray, vals: A.Array) -> A.Array:
    """Scatter sparse values into a dense (with nulls) leaf array."""
    if isinstance(leaf_type, T.Primitive):
        out = np.zeros(out_n, dtype=np.dtype(leaf_type.dtype))
        out[valid_mask] = vals.values
        return A.PrimitiveArray(leaf_type, validity, out)
    if isinstance(leaf_type, T.FixedSizeList):
        out = np.zeros((out_n, leaf_type.size), dtype=np.dtype(leaf_type.child.dtype))
        out[valid_mask] = vals.values
        return A.FixedSizeListArray(leaf_type, validity, out)
    if isinstance(leaf_type, (T.Utf8, T.Binary)):
        lengths = np.zeros(out_n, dtype=np.int64)
        lengths[valid_mask] = vals.offsets[1:] - vals.offsets[:-1]
        offsets = np.zeros(out_n + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return A.VarBinaryArray(leaf_type, validity, offsets, vals.data.copy())
    raise TypeError(leaf_type)


def _merge(typ: T.DataType, projections) -> A.Array:
    """Merge per-leaf projection arrays back into the full nested array."""
    if isinstance(typ, T.Struct):
        groups: Dict[str, list] = {}
        validity = None
        for arr, path in projections:
            assert isinstance(arr, A.StructArray)
            name = arr.children[0][0]
            groups.setdefault(name, []).append((arr.children[0][1], path[1:]))
            validity = arr.validity if validity is None else validity
        children = []
        for fname, ftyp in typ.fields:
            sub = _merge(ftyp, groups[fname])
            children.append((fname, sub))
        return A.StructArray(typ, validity, tuple(children))
    if isinstance(typ, T.List):
        # all projections share offsets/validity at this level
        first = projections[0][0]
        assert isinstance(first, A.ListArray)
        child_projs = [(arr.child, path) for arr, path in projections]
        child = _merge(typ.child, child_projs)
        return A.ListArray(typ, first.validity, first.offsets, child)
    # leaf
    arr = projections[0][0]
    arr.type = typ
    return arr
