"""Versioned checkpoint codec — parity with encode.go.

The reference serializes the pointer graph node-by-node with a varint
codec and rebuilds pointers in a two-pass import (encode.go:133-262).
The array representation makes this trivial: the checkpoint IS the
arrays. We keep the reference's durable ideas:

  * version header                      (encodingVersion, encode.go:128)
  * distance stored by NAME, resolved through the registry on import —
    unregistered name -> error          (encode.go:193-195, distance.go:25)
  * atomic write via temp file + rename (renameio, encode.go:304-322)
  * an imported graph "converges onto" the hyper-params of the file
    (encode.go:178-179)

Format: numpy .npz (uncompressed by default — zlib over GB-scale random
f32 buys ~5% and costs minutes; ``compress=True`` restores it) + a JSON
config entry + a key table. Plain-int key tables (v3) ship as one int64
array + None mask; anything else uses tagged JSON (io/table.key_to_json
— injective and code-exec-safe, unlike pickle; matches the reference's
safe binary codec posture, encode.go). Version-1 checkpoints stored
keys with pickle; loading those requires an explicit
``allow_pickle=True`` opt-in because unpickling untrusted data executes
arbitrary code.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json
import os
import pickle
import tempfile
from typing import Any, Optional

import numpy as np

FORMAT_VERSION = 3


def export_graph(graph, fileobj, compress: bool = False) -> None:
    """Serialize a Graph to a writable binary stream — the stream-based
    twin of save_graph (reference Graph.Export(w), encode.go:133).

    ``compress`` is off by default: zlib over multi-GB float32 vector
    tables buys ~5% on random embeddings and costs minutes of
    single-core CPU at 8M rows; turn it on for small or highly
    redundant graphs."""
    if compress:
        np.savez_compressed(fileobj, **_payload(graph))
    else:
        np.savez(fileobj, **_payload(graph))


def import_graph(fileobj, config=None, allow_pickle: bool = False):
    """Deserialize a Graph from a readable binary stream
    (reference Graph.Import(r), encode.go:180)."""
    return _load(np.load(fileobj, allow_pickle=False), config,
                 allow_pickle=allow_pickle)


def _payload(graph) -> dict:
    from hnsw_tpu.config import METRICS
    from hnsw_tpu.io import table as T
    from hnsw_tpu.ops.distance import registered

    cfg = graph.cfg
    metric = cfg.metric
    if metric not in METRICS and registered(metric) is None:
        # mirror encode.go's refusal to export unnamed distances
        raise ValueError(
            f"metric {metric!r} is not builtin and not registered; call "
            f"register_distance() first")

    n = graph.slots.capacity_used
    host = graph.host
    ncap = min(n, host.neighbors.shape[1]) if n else 0
    # Key-table encoding: plain-int key tables (the bulk-ingest common
    # case) ship as ONE int64 array + a None mask — the per-key
    # tagged-JSON path costs minutes of Python at 8M keys. Mixed/exotic
    # keys keep the injective tagged-JSON codec (io/table.key_to_json).
    s2k = graph.slots.slot_to_key
    all_int = all(k is None or (type(k) is int and -2**63 <= k < 2**63)
                  for k in s2k)
    if all_int:
        key_entries = {
            "keys_int": np.asarray([-1 if k is None else k for k in s2k],
                                   np.int64),
            "keys_none": np.asarray([k is None for k in s2k], bool),
            "keys_free": np.asarray(graph.slots.free, np.int64),
        }
    else:
        key_entries = {
            "keys_json": np.frombuffer(json.dumps({
                "slot_to_key": [None if k is None else T.key_to_json(k)
                                for k in s2k],
                "free": [int(s) for s in graph.slots.free],
            }).encode(), dtype=np.uint8),
        }
    payload = {
        "version": np.int64(FORMAT_VERSION),
        "config": np.frombuffer(json.dumps(
            dataclasses.asdict(cfg)).encode(), dtype=np.uint8),
        **key_entries,
        "vectors": (graph.store.vectors[:n] if n else
                    np.zeros((0, 0), np.float32)),
        "alive": (graph.store.alive[:n] if n else np.zeros((0,), bool)),
        "neighbors": host.neighbors[:max(host.top + 1, 1), :ncap],
        "levels": host.levels[:ncap],
        "entry": np.int64(host.entry),
        "top": np.int64(host.top),
        "count": np.int64(host.count),
    }
    calib = graph.calibration_state()
    if calib["ef_calib"] or calib["ef_default"] is not None:
        # persist calibrate_ef results: a reopened 8M index must not
        # re-pay the minutes-long host oracle scan
        payload["calib"] = np.frombuffer(
            json.dumps(calib).encode(), dtype=np.uint8)
    return payload


def save_graph(graph, path: str, compress: bool = False) -> None:
    """Atomically write a Graph checkpoint to ``path`` (see
    export_graph for the ``compress`` trade-off)."""
    payload = _payload(graph)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            if compress:
                np.savez_compressed(f, **payload)
            else:
                np.savez(f, **payload)
        os.replace(tmp, path)  # atomic (renameio semantics)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_graph(path: str, config=None, allow_pickle: bool = False):
    """Load a checkpoint into a fresh Graph.

    ``config`` overrides the stored hyper-params (the reference allows
    importing under different params, encode.go:178-179); the metric
    must be builtin or registered. ``allow_pickle`` is required to load
    legacy v1 checkpoints whose key table was pickled — only set it for
    checkpoints you trust (unpickling executes arbitrary code).
    """
    with np.load(path, allow_pickle=False) as z:
        return _load(z, config, allow_pickle=allow_pickle)


def _load(z, config=None, allow_pickle: bool = False):
    from hnsw_tpu.config import GraphConfig
    from hnsw_tpu.index.hnsw import Graph
    from hnsw_tpu.io import table as T
    from hnsw_tpu.ops.distance import resolve_metric

    version = int(z["version"])
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {version} newer than supported "
            f"{FORMAT_VERSION}")
    stored_cfg = json.loads(bytes(z["config"].tobytes()).decode())
    if "keys_int" in z.files:
        vals = z["keys_int"].tolist()        # one pass -> Python ints
        # .tolist() the mask too: per-element numpy bool indexing costs
        # seconds at 8M+ slots on the 1-core host, on EVERY load/resume
        nones = z["keys_none"].tolist()
        key_table = {
            "slot_to_key": [None if n else v
                            for n, v in zip(nones, vals)],
            "free": z["keys_free"].tolist(),
        }
    elif "keys_json" in z.files:
        raw = json.loads(bytes(z["keys_json"].tobytes()).decode())
        key_table = {
            "slot_to_key": [None if j is None else T.key_from_json(j)
                            for j in raw["slot_to_key"]],
            "free": [int(s) for s in raw["free"]],
        }
    else:  # v1 legacy: pickled key table
        if not allow_pickle:
            raise ValueError(
                "this checkpoint stores its key table with pickle "
                "(format v1); pass allow_pickle=True only if you trust "
                "its origin — unpickling executes arbitrary code")
        key_table = pickle.loads(bytes(z["keys"].tobytes()))
    vectors = z["vectors"]
    alive = z["alive"]
    neighbors = z["neighbors"]
    levels = z["levels"]
    entry = int(z["entry"])
    top = int(z["top"])
    count = int(z["count"])

    cfg = config or GraphConfig(**stored_cfg)
    resolve_metric(cfg.metric)  # raise if unknown/unregistered
    g = Graph(config=cfg)

    # restore key table
    g.slots.slot_to_key = list(key_table["slot_to_key"])
    g.slots.free = list(key_table["free"])
    g.slots.key_to_slot = {k: i for i, k in enumerate(g.slots.slot_to_key)
                           if k is not None}

    n = vectors.shape[0]
    if n:
        g.store.ensure_dim(vectors.shape[1])
        g.store.ensure_capacity(n)
        g.store.vectors[:n] = vectors
        v64 = vectors.astype(np.float64)
        g.store.sq_norms[:n] = np.sum(v64 * v64, axis=1).astype(np.float32)
        g.store.alive[:n] = alive

        host = g.host
        host._ensure(n - 1, neighbors.shape[0] - 1)
        # restore by the STORED widths: a mid-build checkpoint (host
        # slices grow arrays lazily) covers only the inserted prefix —
        # the rest stays at the -1 defaults, which is exactly the
        # "pending" state resume_build looks for
        host.neighbors[:neighbors.shape[0], :neighbors.shape[1]] = \
            neighbors
        host.levels[:levels.shape[0]] = levels
        host.entry = entry
        host.top = top
        host.count = count
    if "calib" in z.files:
        g.restore_calibration(
            json.loads(bytes(z["calib"].tobytes()).decode()))
    g._dirty = True
    return g


class SavedGraph:
    """Convenience wrapper: a Graph bound to a file path
    (encode.go:268-327 SavedGraph/LoadSavedGraph)."""

    def __init__(self, graph, path: str):
        self.graph = graph
        self.path = path

    def save(self) -> None:
        save_graph(self.graph, self.path)

    @classmethod
    def load(cls, path: str, config=None) -> "SavedGraph":
        from hnsw_tpu.index.hnsw import Graph
        if os.path.exists(path):
            g = load_graph(path, config=config)
        else:
            from hnsw_tpu.config import GraphConfig
            g = Graph(config=config or GraphConfig())
        return cls(g, path)
