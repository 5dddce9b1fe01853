"""Fragment manifest: the metadata model for a multi-file Lance dataset.

A dataset is an ordered list of Lance files ("fragments").  Rows get global
ids by concatenating fragment row ranges; bytes get global addresses by
concatenating fragment payloads (8-byte aligned) into one address space.
Both mappings live here:

* ``row_starts`` — fragment *f* holds global rows
  ``[row_starts[f], row_starts[f] + n_rows_f)``; a vectorized searchsorted
  maps any global row id to ``(fragment, local row)``;
* ``Fragment.base`` — local byte offset *o* of fragment *f* is global byte
  ``base_f + o``, so the shared scheduler sector-aligns and coalesces
  across file boundaries.  A boundary sector may serve the tail of one
  fragment and the head of the next — that sharing *is* the cross-file
  coalescing.

The manifest is built by parsing each file's footer (schema + row counts);
schemas must match across fragments.  ``version`` numbers the manifests a
dataset writer commits (v1..vN); a dataset built straight from files is
version 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import arrays as A
from ..core.file import WriteOptions, read_footer, write_table
from ..core.io_sim import Disk

__all__ = ["Fragment", "Manifest", "build_dataset_disk", "footer_meta",
           "write_fragments"]

FRAGMENT_ALIGN = 8  # byte alignment of fragment bases in the global space


@dataclasses.dataclass(frozen=True)
class Fragment:
    """One file of the dataset, placed in the global row/byte spaces."""

    id: int
    base: int        # global byte offset of this file's byte 0
    nbytes: int      # file size
    n_rows: int
    row_start: int   # global id of this file's row 0

    @property
    def row_stop(self) -> int:
        return self.row_start + self.n_rows


def footer_meta(fb: bytes) -> Dict:
    """Parse a Lance file's footer from raw bytes (schema + leaf metadata)."""
    meta, _ = read_footer(lambda o, s: fb[o : o + s], len(fb))
    return meta


class Manifest:
    """Fragment list + the global row/byte address maps.

    ``version`` is 0 for a plain (unversioned) manifest built directly from
    files; the dataset writer numbers its committed manifests v1..vN.
    """

    def __init__(self, fragments: Sequence[Fragment], columns: List[Dict],
                 version: int = 0):
        self.fragments: List[Fragment] = list(fragments)
        self.columns = columns  # schema from fragment 0's footer
        self.version = int(version)
        self.n_rows = sum(f.n_rows for f in self.fragments)
        # row_starts[f] = first global row of fragment f (monotone, len F)
        self.row_starts = np.array([f.row_start for f in self.fragments],
                                   dtype=np.int64)

    @property
    def n_fragments(self) -> int:
        return len(self.fragments)

    @property
    def column_names(self) -> List[str]:
        return [c["name"] for c in self.columns]

    @classmethod
    def from_files(cls, files: Sequence[bytes]) -> "Manifest":
        if not files:
            raise ValueError("dataset needs at least one fragment")
        frags: List[Fragment] = []
        columns: Optional[List[Dict]] = None
        base = row = 0
        for i, fb in enumerate(files):
            meta = footer_meta(fb)
            cols = meta["columns"]
            if columns is None:
                columns = cols
            else:
                got = [(c["name"], c["type"]) for c in cols]
                want = [(c["name"], c["type"]) for c in columns]
                if got != want:
                    raise ValueError(
                        f"fragment {i} schema {got!r} does not match "
                        f"fragment 0 schema {want!r}")
            n_rows = cols[0]["n_rows"] if cols else 0
            frags.append(Fragment(id=i, base=base, nbytes=len(fb),
                                  n_rows=n_rows, row_start=row))
            row += n_rows
            base += len(fb) + (-len(fb)) % FRAGMENT_ALIGN
        return cls(frags, columns)

    # -- global row ids ------------------------------------------------------
    def locate(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Vector-map global row ids to ``(fragment index, local row)``."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) and (int(rows.min()) < 0 or int(rows.max()) >= self.n_rows):
            raise IndexError(
                f"global rows out of bounds for {self.n_rows}-row dataset")
        fi = np.searchsorted(self.row_starts, rows, side="right") - 1
        return fi, rows - self.row_starts[fi]


def build_dataset_disk(files: Sequence[bytes]) -> Tuple[Manifest, Disk]:
    """Concatenate fragment files into one global-address-space disk."""
    manifest = Manifest.from_files(files)
    total = manifest.fragments[-1].base + manifest.fragments[-1].nbytes
    mem = np.zeros(total, dtype=np.uint8)
    for frag, fb in zip(manifest.fragments, files):
        mem[frag.base : frag.base + frag.nbytes] = np.frombuffer(fb, np.uint8)
    return manifest, Disk(mem)


def write_fragments(table: Dict[str, A.Array], n_fragments: int,
                    opts: Optional[WriteOptions] = None) -> List[bytes]:
    """Split a table row-wise into ``n_fragments`` Lance files.

    The test/benchmark ingest path: contiguous, near-equal row ranges, each
    written with :func:`~repro.core.file.write_table`.
    """
    if n_fragments <= 0:
        raise ValueError("n_fragments must be positive")
    n = len(next(iter(table.values())))
    if n_fragments > max(n, 1):
        raise ValueError(f"cannot split {n} rows into {n_fragments} fragments")
    bounds = np.linspace(0, n, n_fragments + 1).astype(np.int64)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        idx = np.arange(lo, hi, dtype=np.int64)
        out.append(write_table({k: v.take(idx) for k, v in table.items()},
                               opts))
    return out
