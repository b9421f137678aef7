"""Content-addressed on-disk result store: spec-hash -> shards.

Layout (one directory per spec hash, one shard per cell):

    <root>/
      <spec_hash>/
        spec.json                  # the canonical SweepSpec
        shards/<cell_id>.jsonl     # one record per line (+ trailing _meta)
        shards/<cell_id>.parquet   # same rows, if format="parquet"

A shard is written atomically (tmp file + ``os.replace``), so an
interrupted sweep leaves only whole shards behind and ``resume`` is just
"skip cells whose shard exists". Cell ids are content addresses of the
cell parameters (not of the enclosing spec), so any spec whose grid
overlaps a previous sweep's reuses those shards via hard links into its
own spec directory.

JSONL is the default: deterministic bytes (sorted keys, repr-float
round-trip), diffable, zero-dependency. ``format="parquet"`` uses pyarrow
when importable and falls back to JSONL otherwise — the container may not
ship it, and a sweep must not fail over a storage nicety.

The port's copy of ``repro.sweeps.store``, unchanged: the same shards,
byte for byte, in both packages.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.sweeps.spec import SweepCell, SweepSpec

_META_KEY = "_meta"


def _parquet_io():
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
        return pa, pq
    except Exception:
        return None


class SweepStore:
    def __init__(self, root: str, fmt: str = "jsonl"):
        assert fmt in ("jsonl", "parquet"), fmt
        if fmt == "parquet" and _parquet_io() is None:
            fmt = "jsonl"          # gate the optional dep, don't require it
        self.root = root
        self.fmt = fmt
        # shared cell pool: shards land here once, spec dirs hard-link in
        self._pool = os.path.join(root, "cells")
        os.makedirs(self._pool, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def spec_dir(self, spec: SweepSpec) -> str:
        return os.path.join(self.root, spec.spec_hash())

    def _shard_name(self, cell: SweepCell) -> str:
        return f"{cell.cell_id()}.{self.fmt}"

    def _pool_path(self, cell: SweepCell) -> str:
        return os.path.join(self._pool, self._shard_name(cell))

    def shard_path(self, spec: SweepSpec, cell: SweepCell) -> str:
        return os.path.join(self.spec_dir(spec), "shards",
                            self._shard_name(cell))

    # -- spec registration --------------------------------------------------

    def register(self, spec: SweepSpec) -> str:
        """Create the spec directory (idempotent), persist the canonical
        spec, and link in any already-computed overlapping cells."""
        d = self.spec_dir(spec)
        os.makedirs(os.path.join(d, "shards"), exist_ok=True)
        spec_file = os.path.join(d, "spec.json")
        if not os.path.exists(spec_file):
            _atomic_write_text(spec_file, spec.to_json() + "\n")
        for cell in spec.expand():
            self._link_from_pool(spec, cell)
        return d

    def _link_from_pool(self, spec: SweepSpec, cell: SweepCell,
                        refresh: bool = False) -> None:
        """Materialize the spec-dir shard as a hard link to the pool file.
        ``refresh=True`` re-links even if the spec-dir entry exists —
        required after a rewrite, because ``os.replace`` on the pool path
        swaps the *inode* and a pre-existing link would keep serving the
        old bytes."""
        dst = self.shard_path(spec, cell)
        src = self._pool_path(cell)
        if not os.path.exists(src) or (os.path.exists(dst) and not refresh):
            return
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            tmp = dst + ".lnk"
            if os.path.exists(tmp):
                os.unlink(tmp)
            os.link(src, tmp)
            os.replace(tmp, dst)       # atomic swap onto the new inode
        except OSError:           # cross-device etc: copy bytes instead
            with open(src, "rb") as f:
                _atomic_write_bytes(dst, f.read())

    # -- shard IO -----------------------------------------------------------

    def completed(self, spec: SweepSpec, cell: SweepCell) -> bool:
        return os.path.exists(self.shard_path(spec, cell))

    def pending(self, spec: SweepSpec) -> List[SweepCell]:
        return [c for c in spec.expand() if not self.completed(spec, c)]

    def write_shard(self, spec: SweepSpec, cell: SweepCell,
                    records: List[dict], meta: dict) -> str:
        """Atomically persist one cell's records + meta, into the shared
        pool first and then hard-linked into the spec directory."""
        meta = dict(meta, cell=cell.canonical())
        pool_path = self._pool_path(cell)
        if self.fmt == "parquet":
            self._write_parquet(pool_path, records, meta)
        else:
            lines = [json.dumps(r, sort_keys=True) for r in records]
            lines.append(json.dumps({_META_KEY: meta}, sort_keys=True))
            _atomic_write_text(pool_path, "\n".join(lines) + "\n")
        self._link_from_pool(spec, cell, refresh=True)
        return self.shard_path(spec, cell)

    def read_shard(self, spec: SweepSpec, cell: SweepCell
                   ) -> Tuple[List[dict], Optional[dict]]:
        path = self.shard_path(spec, cell)
        if self.fmt == "parquet":
            return self._read_parquet(path)
        records, meta = [], None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                if _META_KEY in row:
                    meta = row[_META_KEY]
                else:
                    records.append(row)
        return records, meta

    def iter_records(self, spec: SweepSpec) -> Iterator[dict]:
        """Stream every completed cell's records (missing shards are
        skipped — callers resuming mid-sweep see the partial view)."""
        for cell in spec.expand():
            if self.completed(spec, cell):
                records, _ = self.read_shard(spec, cell)
                yield from records

    def metas(self, spec: SweepSpec) -> Dict[str, dict]:
        out = {}
        for cell in spec.expand():
            if self.completed(spec, cell):
                _, meta = self.read_shard(spec, cell)
                if meta is not None:
                    out[cell.cell_id()] = meta
        return out

    # -- parquet back end ---------------------------------------------------

    def _write_parquet(self, path: str, records: List[dict],
                       meta: dict) -> None:
        pa, pq = _parquet_io()
        cols = sorted({k for r in records for k in r})
        table = pa.table({c: [r.get(c) for r in records] for c in cols})
        table = table.replace_schema_metadata(
            {b"sweep_meta": json.dumps(meta, sort_keys=True).encode()})
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        os.close(fd)
        try:
            pq.write_table(table, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _read_parquet(self, path: str):
        pa, pq = _parquet_io()
        table = pq.read_table(path)
        meta = None
        md = table.schema.metadata or {}
        if b"sweep_meta" in md:
            meta = json.loads(md[b"sweep_meta"].decode())
        # the writer unions columns across heterogeneous rows (analytic vs
        # sim records in one shard) and fills gaps with null; drop those so
        # a parquet round-trip yields the same dicts JSONL does (readers
        # key on field *absence* — e.g. records() kind normalization)
        records = [{k: v for k, v in row.items() if v is not None}
                   for row in table.to_pylist()]
        return records, meta


def _atomic_write_text(path: str, text: str) -> None:
    _atomic_write_bytes(path, text.encode())


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
