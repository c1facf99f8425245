"""Nested Parquet column assembly, Dremel record reconstruction
(counterpart of the reference's ``parquet/nested.py``).

The native reader decodes nested leaves into compact present values plus
raw definition and repetition levels, and dumps the schema tree as text.
This module rebuilds the tree and assembles the shapes the reference
assembles, as the port's columns:

- STRUCTs of primitives and strings, nested to any depth (no lists
  inside): a STRUCT column whose fields share its row count;
- a top-level LIST of a primitive or string element (the standard
  3-level ``optional group (LIST) { repeated group list { element } }``):
  int32 offsets, validity and one child.

Other shapes (a LIST of STRUCTs, a STRUCT holding a LIST) raise
``NotImplementedError`` as the reference does. The level arithmetic runs
in numpy on the host, where the levels are by construction; the
assembled buffers are then staged to the target device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import types as t
from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.types import DType, TypeId

_CONV_LIST = 3  # parquet ConvertedType.LIST


@dataclass
class SchemaNode:
    name: str
    num_children: int
    repetition: int  # 0 REQUIRED, 1 OPTIONAL, 2 REPEATED
    physical: int
    converted: int
    scale: int
    precision: int
    type_length: int
    def_level: int = 0   # cumulative def level at this node
    rep_level: int = 0
    children: list = field(default_factory=list)
    leaf_index: int = -1  # preorder leaf ordinal (chunks order), -1 = group

    @property
    def is_leaf(self) -> bool:
        return self.num_children == 0


def _unescape_name(s: str) -> str:
    """Inverse of the reader's dump escaping (\\t, \\n, \\\\ in names)."""
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"t": "\t", "n": "\n", "\\": "\\"}.get(nxt, nxt))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def parse_schema_desc(desc: str) -> list[SchemaNode]:
    """Rebuild the top-level fields from the reader's preorder dump."""
    nodes = []
    for ln in (ln for ln in desc.split("\n") if ln):
        parts = ln.rsplit("\t", 7)  # name is escaped; split from the right
        nodes.append(SchemaNode(
            name=_unescape_name(parts[0]), num_children=int(parts[1]),
            repetition=int(parts[2]), physical=int(parts[3]),
            converted=int(parts[4]), scale=int(parts[5]),
            precision=int(parts[6]), type_length=int(parts[7])))
    pos = 0
    leaf_counter = 0

    def build(def_level: int, rep_level: int) -> SchemaNode:
        nonlocal pos, leaf_counter
        node = nodes[pos]
        pos += 1
        if node.repetition != 0:
            def_level += 1
        if node.repetition == 2:
            rep_level += 1
        node.def_level = def_level
        node.rep_level = rep_level
        if node.is_leaf:
            node.leaf_index = leaf_counter
            leaf_counter += 1
        else:
            node.children = [build(def_level, rep_level)
                             for _ in range(node.num_children)]
        return node

    top = []
    while pos < len(nodes):
        top.append(build(0, 0))
    return top


def leaves_of(node: SchemaNode) -> list[SchemaNode]:
    if node.is_leaf:
        return [node]
    out = []
    for c in node.children:
        out.extend(leaves_of(c))
    return out


@dataclass
class LeafData:
    """Compact decoded leaf and its levels, as copied off the native
    reader (host numpy arrays)."""

    values: np.ndarray | None          # fixed-width values (n_present,)
    offsets: np.ndarray | None         # BYTE_ARRAY: int32[n_present+1]
    chars: np.ndarray | None
    defs: np.ndarray                   # uint8[n_levels]
    reps: np.ndarray | None            # uint8[n_levels] when max_rep > 0
    dtype: DType                       # mapped leaf dtype


def _expand_leaf(leaf: LeafData, positions_valid: np.ndarray,
                 device: torch.device) -> Column:
    """Compact present values -> a full-length leaf column over the
    positions ``positions_valid`` marks (its length is the row count)."""
    n = positions_valid.shape[0]
    validity = torch.from_numpy(positions_valid.copy()).to(device)
    if leaf.dtype.is_string:
        lengths = (leaf.offsets[1:] - leaf.offsets[:-1]) \
            if leaf.offsets is not None else np.zeros(0, np.int32)
        out_len = np.zeros(n, dtype=np.int64)
        out_len[positions_valid] = lengths
        offsets = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(out_len, out=offsets[1:])
        # chars are already in present-row order, the output's order
        chars = leaf.chars if leaf.chars is not None \
            else np.zeros(0, np.uint8)
        return Column(t.STRING, torch.from_numpy(offsets).to(device),
                      validity, chars=torch.from_numpy(
                          np.ascontiguousarray(chars)).to(device))
    out = np.zeros(n, dtype=leaf.dtype.storage_dtype)
    if leaf.values is not None and leaf.values.size:
        out[positions_valid] = leaf.values
    return Column(leaf.dtype, torch.from_numpy(out).to(device), validity)


def assemble_struct(node: SchemaNode, leaf_data: dict,
                    device: torch.device) -> Column:
    """STRUCT with no repeated field beneath: the fields share the row
    count, and each level's presence comes straight off the def levels
    (a node is present where def >= its own def level)."""
    for lf in leaves_of(node):
        if lf.rep_level > 0:
            raise NotImplementedError(
                f"lists inside structs are not supported yet ({lf.name})")

    def build(nd: SchemaNode) -> Column:
        if nd.is_leaf:
            ld = leaf_data[nd.leaf_index]
            return _expand_leaf(ld, ld.defs == nd.def_level, device)
        kids = [build(c) for c in nd.children]
        defs = leaf_data[leaves_of(nd)[0].leaf_index].defs
        return Column(DType(TypeId.STRUCT),
                      torch.zeros((defs.shape[0],), dtype=torch.uint8,
                                  device=device),
                      torch.from_numpy(defs >= nd.def_level).to(device),
                      children=kids)

    return build(node)


def assemble_list(node: SchemaNode, leaf_data: dict,
                  device: torch.device) -> Column:
    """Standard 3-level LIST of a primitive or string element."""
    lvs = leaves_of(node)
    if len(lvs) != 1:
        raise NotImplementedError(
            f"only LIST of a single leaf element is supported ({node.name})")
    # the element must BE a leaf, not a single-field struct
    rep_group = node.children[0] if node.children else None
    if rep_group is None or rep_group.repetition != 2:
        raise NotImplementedError(
            f"unrecognized LIST encoding for {node.name}")
    elem_node = rep_group if rep_group.is_leaf else (
        rep_group.children[0] if len(rep_group.children) == 1 else None)
    if elem_node is None or not elem_node.is_leaf:
        raise NotImplementedError(
            f"LIST of struct elements is not supported yet ({node.name})")
    elem = lvs[0]
    if elem.rep_level != 1:
        raise NotImplementedError("nested lists are not supported")
    ld = leaf_data[elem.leaf_index]
    defs, reps = ld.defs, ld.reps
    if reps is None:
        raise ValueError("list leaf decoded without repetition levels")
    # the repeated group sits one def level above the list group
    def_list = node.def_level          # list group present (may be empty)
    def_entry = def_list + 1           # an element slot exists
    row_start = reps == 0              # each top row begins at rep 0
    n_rows = int(row_start.sum())
    row_id = np.cumsum(row_start) - 1
    entry = defs >= def_entry
    counts = np.bincount(row_id[entry], minlength=n_rows)
    offsets = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    # a list is null iff def < def_list at its row's (single) start entry
    list_valid = torch.from_numpy(defs[row_start] >= def_list).to(device)
    elem_present = defs[entry] == elem.def_level
    child = _expand_leaf(
        LeafData(ld.values, ld.offsets, ld.chars, defs[entry], None,
                 ld.dtype),
        elem_present, device)
    return Column(t.LIST, torch.from_numpy(offsets).to(device), list_valid,
                  children=[child])
