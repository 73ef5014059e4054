"""Vector-table codecs: Parquet / Arrow IPC / npz.

Schemas mirror the reference's four-file layout (parquet/storage.go:
127-168; arrow/storage.go:45-85):

  vectors.(parquet|arrow):   (key, vector list<float32>)
  layers.(parquet|arrow):    (layer_id int32, key)
  neighbors.(parquet|arrow): (layer_id int32, key, neighbor_key)
  metadata.(parquet|arrow):  JSON-encoded params blob

Keys serialize as int64 when all keys are ints, else as strings with a
declared key_kind (absorbing the reference's key_utils.go coercion
matrices). pyarrow is available in this image; the npz format is the
dependency-free fallback.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.ipc as pa_ipc
    import pyarrow.parquet as pq
    HAVE_ARROW = True
except Exception:  # pragma: no cover
    HAVE_ARROW = False


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def key_to_json(k: Any) -> Any:
    """Tagged, injective, code-exec-safe key encoding.

    Every key type gets an explicit tag so round-trips preserve identity
    exactly (a string key "1" stays a string; tuple keys stay hashable
    tuples). Mirrors the exhaustive-but-safe spirit of the reference's
    key coercion matrix (parquet/key_utils.go:42-235) without sniffing.
    """
    if isinstance(k, bool):
        return ["b", bool(k)]
    if isinstance(k, (int, np.integer)):
        return ["i", int(k)]
    if isinstance(k, (float, np.floating)):
        return ["f", float(k)]
    if isinstance(k, str):
        return ["s", k]
    if isinstance(k, bytes):
        return ["y", k.hex()]
    if isinstance(k, tuple):
        return ["t", [key_to_json(x) for x in k]]
    raise TypeError(
        f"unsupported key type {type(k).__name__}; keys must be "
        f"int/str/float/bool/bytes or tuples thereof")


def key_from_json(j: Any) -> Any:
    tag, payload = j[0], (j[1] if len(j) > 1 else None)
    if tag == "b":
        return bool(payload)
    if tag == "i":
        return int(payload)
    if tag == "f":
        return float(payload)
    if tag == "s":
        return payload
    if tag == "y":
        return bytes.fromhex(payload)
    if tag == "t":
        return tuple(key_from_json(x) for x in payload)
    raise ValueError(f"unknown key tag {tag!r}")


def encode_keys(keys: Sequence[Any]) -> Tuple[list, str]:
    """-> (encoded list, key_kind). int64 fast path when all keys are
    ints (and none are bools); otherwise tagged-JSON strings ("json")."""
    if all(isinstance(k, (int, np.integer)) and not isinstance(k, bool)
           for k in keys):
        return [int(k) for k in keys], "int64"
    return [json.dumps(key_to_json(k)) for k in keys], "json"


def decode_keys(vals: Sequence[Any], kind: str) -> List[Any]:
    if kind == "int64":
        return [int(v) for v in vals]
    if kind == "json":
        return [key_from_json(json.loads(v)) for v in vals]
    # legacy kind "str" (round-1 files): best-effort heuristic decode
    out = []
    for v in vals:
        if isinstance(v, str) and v[:1] in "[{0123456789-\"tfn":
            try:
                decoded = json.loads(v)
                out.append(tuple(decoded) if isinstance(decoded, list)
                           else decoded)
                continue
            except (json.JSONDecodeError, ValueError):
                pass
        out.append(v)
    return out


def write_vectors(path: str, keys: Sequence[Any], vectors: np.ndarray,
                  fmt: str, compression: str = "snappy") -> None:
    """(key, vector) table (parquet/storage.go:127's schema)."""
    vectors = np.asarray(vectors, np.float32)
    enc, kind = encode_keys(keys)
    if fmt == "npz":
        _atomic_write(path, lambda p: np.savez_compressed(
            open(p, "wb"),
            keys=(np.asarray(enc, np.int64) if kind == "int64"
                  else np.asarray(enc, dtype=object).astype("U")),
            vectors=vectors, key_kind=np.str_(kind)))
        return
    if not HAVE_ARROW:  # pragma: no cover
        raise RuntimeError("pyarrow unavailable; use fmt='npz'")
    key_arr = (pa.array(enc, pa.int64()) if kind == "int64"
               else pa.array(enc, pa.string()))
    vec_arr = pa.FixedSizeListArray.from_arrays(
        pa.array(vectors.ravel(), pa.float32()), vectors.shape[1]
        if vectors.size else 1)
    table = pa.table({"key": key_arr, "vector": vec_arr})
    table = table.replace_schema_metadata({"key_kind": kind,
                                           "dim": str(vectors.shape[1]
                                                      if vectors.size else 0)})
    if fmt == "parquet":
        # vector column uncompressed: general-purpose codecs neither
        # shrink nor speed up random float32 payloads — snappy over a
        # 512 MB 1M x 128 table was most of a 127 s persist
        comp = {"key": compression, "vector": "none"}
        _atomic_write(path, lambda p: pq.write_table(
            table, p, compression=comp))
    elif fmt == "arrow":
        def w(p):
            with pa_ipc.new_file(p, table.schema) as f:
                f.write_table(table)
        _atomic_write(path, w)
    else:
        raise ValueError(f"unknown format {fmt}")


def read_vectors(path: str, fmt: str) -> Tuple[List[Any], np.ndarray]:
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as z:
            kind = str(z["key_kind"])
            keys = decode_keys(z["keys"].tolist() if kind == "int64"
                               else [str(x) for x in z["keys"]], kind)
            return keys, z["vectors"]
    if not HAVE_ARROW:  # pragma: no cover
        raise RuntimeError("pyarrow unavailable; use fmt='npz'")
    if fmt == "parquet":
        table = pq.read_table(path)
    elif fmt == "arrow":
        with pa_ipc.open_file(path) as f:
            table = f.read_all()
    else:
        raise ValueError(f"unknown format {fmt}")
    meta = table.schema.metadata or {}
    kind = (meta.get(b"key_kind") or b"int64").decode()
    if kind == "int64":  # bulk int path: ~10x the per-item to_pylist
        keys = table.column("key").combine_chunks().to_numpy(
            zero_copy_only=False).tolist()
    else:
        keys = decode_keys(table.column("key").to_pylist(), kind)
    vec_col = table.column("vector")
    vecs = np.asarray(vec_col.combine_chunks().flatten(),
                      dtype=np.float32)
    n = len(keys)
    dim = int((meta.get(b"dim") or b"0").decode()) or (
        len(vecs) // n if n else 0)
    return keys, vecs.reshape(n, dim) if n else np.zeros((0, 0), np.float32)


def write_edges(path: str, layer_ids: np.ndarray, keys: Sequence[Any],
                neighbor_keys: Sequence[Any], fmt: str,
                compression: str = "snappy") -> None:
    """neighbors table (layer_id, key, neighbor_key)
    (parquet/storage.go:127-168)."""
    # encode jointly so both columns share one key_kind
    both, kind = encode_keys(list(keys) + list(neighbor_keys))
    enc_k, enc_n = both[:len(keys)], both[len(keys):]
    if fmt == "npz":
        _atomic_write(path, lambda p: np.savez_compressed(
            open(p, "wb"), layer_ids=np.asarray(layer_ids, np.int32),
            keys=np.asarray(enc_k), neighbor_keys=np.asarray(enc_n),
            key_kind=np.str_(kind)))
        return
    if not HAVE_ARROW:  # pragma: no cover
        raise RuntimeError("pyarrow unavailable; use fmt='npz'")
    kt = pa.int64() if kind == "int64" else pa.string()
    table = pa.table({
        "layer_id": pa.array(np.asarray(layer_ids, np.int32), pa.int32()),
        "key": pa.array(enc_k, kt),
        "neighbor_key": pa.array(enc_n, kt),
    }).replace_schema_metadata({"key_kind": kind})
    if fmt == "parquet":
        _atomic_write(path, lambda p: pq.write_table(
            table, p, compression=compression))
    else:
        def w(p):
            with pa_ipc.new_file(p, table.schema) as f:
                f.write_table(table)
        _atomic_write(path, w)


def write_edges_indexed(path: str, layer_ids: np.ndarray,
                        key_idx: np.ndarray, nbr_idx: np.ndarray,
                        dict_keys: Sequence[Any], fmt: str,
                        compression: str = "snappy") -> None:
    """neighbors/layers table via DICTIONARY-ENCODED key columns.

    Same logical schema as write_edges — (layer_id, key, neighbor_key)
    — but the key columns are Arrow DictionaryArrays built from int32
    index arrays + one dictionary of the n unique keys. The indices are
    numpy arrays end to end: persisting 1M nodes x ~48 edges encodes n
    keys once instead of 48M times (the per-edge Python loops made 1M persists take minutes; the reference
    streams Arrow builders, parquet/graph.go:649-788).
    """
    enc, kind = encode_keys(list(dict_keys))
    layer_ids = np.asarray(layer_ids, np.int32)
    key_idx = np.asarray(key_idx, np.int32)
    nbr_idx = np.asarray(nbr_idx, np.int32)
    if fmt == "npz":
        _atomic_write(path, lambda p: np.savez_compressed(
            open(p, "wb"), layer_ids=layer_ids,
            key_idx=key_idx, neighbor_idx=nbr_idx,
            dict_keys=(np.asarray(enc, np.int64) if kind == "int64"
                       else np.asarray(enc, dtype=object).astype("U")),
            key_kind=np.str_(kind)))
        return
    if not HAVE_ARROW:  # pragma: no cover
        raise RuntimeError("pyarrow unavailable; use fmt='npz'")
    if kind == "int64":
        # RAW-INDEX encoding: plain int32 index columns + the dictionary
        # as int64 bytes in the footer metadata. Parquet decodes int64
        # DictionaryArrays to plain values on read (read_dictionary only
        # applies to byte-array columns), which forced an np.unique
        # re-factorization costing seconds per million edges on reopen;
        # raw indices make the read one zero-copy column fetch +
        # np.frombuffer. Footer holds n keys x 8 B (8 MB at 1M — fine).
        table = pa.table({
            "layer_id": pa.array(layer_ids, pa.int32()),
            "key_idx": pa.array(key_idx, pa.int32()),
            "neighbor_idx": pa.array(nbr_idx, pa.int32()),
        }).replace_schema_metadata({
            "key_kind": kind, "encoding": "rawidx",
            "dict": np.asarray(enc, np.int64).tobytes()})
    else:
        kt = pa.string()
        dict_arr = pa.array(enc, kt)
        table = pa.table({
            "layer_id": pa.array(layer_ids, pa.int32()),
            "key": pa.DictionaryArray.from_arrays(
                pa.array(key_idx, pa.int32()), dict_arr),
            "neighbor_key": pa.DictionaryArray.from_arrays(
                pa.array(nbr_idx, pa.int32()), dict_arr),
        }).replace_schema_metadata({"key_kind": kind,
                                    "encoding": "dict"})
    if fmt == "parquet":
        _atomic_write(path, lambda p: pq.write_table(
            table, p, compression=compression))
    else:
        def w(p):
            with pa_ipc.new_file(p, table.schema) as f:
                f.write_table(table)
        _atomic_write(path, w)


def read_edges_indexed(path: str, fmt: str
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  List[Any]]:
    """-> (layer_ids, key_idx, neighbor_idx, dict_keys) — the
    vectorized twin of read_edges. Files written by write_edges (one
    value per edge) are index-ified on the fly (slower; legacy)."""
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as z:
            if "key_idx" in z:
                kind = str(z["key_kind"])
                dk = decode_keys(z["dict_keys"].tolist()
                                 if kind == "int64"
                                 else [str(x) for x in z["dict_keys"]],
                                 kind)
                return (z["layer_ids"], z["key_idx"],
                        z["neighbor_idx"], dk)
        return _indexify(*read_edges(path, fmt))
    if not HAVE_ARROW:  # pragma: no cover
        raise RuntimeError("pyarrow unavailable; use fmt='npz'")
    if fmt == "parquet":
        # Parquet decodes dictionary columns to plain arrays unless
        # told otherwise — without read_dictionary the fast path below
        # silently degrades to per-edge materialization (measured 26 s
        # for 6.4M edges vs ~2 s with indices).
        table = pq.read_table(
            path, read_dictionary=["key", "neighbor_key"])
    elif fmt == "arrow":
        with pa_ipc.open_file(path) as f:
            table = f.read_all()
    else:
        raise ValueError(f"unknown format {fmt}")
    meta = table.schema.metadata or {}
    kind = (meta.get(b"key_kind") or b"int64").decode()
    if meta.get(b"encoding") == b"rawidx":
        dk = np.frombuffer(meta[b"dict"], np.int64)
        return (table.column("layer_id").combine_chunks().to_numpy(
                    zero_copy_only=False).astype(np.int32, copy=False),
                table.column("key_idx").combine_chunks().to_numpy(
                    zero_copy_only=False).astype(np.int32, copy=False),
                table.column("neighbor_idx").combine_chunks().to_numpy(
                    zero_copy_only=False).astype(np.int32, copy=False),
                dk.tolist())
    kcol = table.column("key").combine_chunks()
    ncol = table.column("neighbor_key").combine_chunks()
    if not pa.types.is_dictionary(kcol.type):
        lid_np = table.column("layer_id").combine_chunks().to_numpy(
            zero_copy_only=False).astype(np.int32)
        if kind == "int64":
            # int64 columns come back PLAIN from parquet (read_dictionary
            # only applies to byte-array columns) — factorize with one
            # vectorized np.unique instead of per-edge Python
            kv = kcol.to_numpy(zero_copy_only=False)
            nv = ncol.to_numpy(zero_copy_only=False)
            vals, inv = np.unique(np.concatenate([kv, nv]),
                                  return_inverse=True)
            inv = inv.astype(np.int32)
            return (lid_np, inv[:len(kv)], inv[len(kv):],
                    [int(v) for v in vals])
        return _indexify(lid_np,
                         decode_keys(kcol.to_pylist(), kind),
                         decode_keys(ncol.to_pylist(), kind))
    # the two columns share one dictionary by construction; tolerate
    # divergence (e.g. after external rewrites) by re-mapping
    kd = decode_keys(kcol.dictionary.to_pylist(), kind)
    nd_vals = ncol.dictionary.to_pylist()
    kidx = kcol.indices.to_numpy(zero_copy_only=False).astype(np.int32)
    nidx = ncol.indices.to_numpy(zero_copy_only=False).astype(np.int32)
    nd = decode_keys(nd_vals, kind)
    if nd != kd:
        pos = {k: i for i, k in enumerate(kd)}
        extra = [k for k in nd if k not in pos]
        for k in extra:
            pos[k] = len(kd)
            kd.append(k)
        remap = np.asarray([pos[k] for k in nd], np.int32)
        nidx = remap[nidx]
    lid_np = table.column("layer_id").combine_chunks().to_numpy(
        zero_copy_only=False).astype(np.int32)
    return lid_np, kidx, nidx, kd


def _indexify(lids, keys, nbrs):
    pos: dict = {}
    for k in keys:
        pos.setdefault(k, len(pos))
    for k in nbrs:
        pos.setdefault(k, len(pos))
    dict_keys = list(pos.keys())
    kidx = np.asarray([pos[k] for k in keys], np.int32)
    nidx = np.asarray([pos[k] for k in nbrs], np.int32)
    return np.asarray(lids, np.int32), kidx, nidx, dict_keys


def read_edges(path: str, fmt: str
               ) -> Tuple[np.ndarray, List[Any], List[Any]]:
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as z:
            if "key_idx" in z:   # dictionary-encoded file: materialize
                kind = str(z["key_kind"])
                dk = decode_keys(z["dict_keys"].tolist()
                                 if kind == "int64"
                                 else [str(x) for x in z["dict_keys"]],
                                 kind)
                return (z["layer_ids"],
                        [dk[i] for i in z["key_idx"]],
                        [dk[i] for i in z["neighbor_idx"]])
            kind = str(z["key_kind"])
            keys = decode_keys(
                z["keys"].tolist() if kind == "int64"
                else [str(x) for x in z["keys"]], kind)
            nbrs = decode_keys(
                z["neighbor_keys"].tolist() if kind == "int64"
                else [str(x) for x in z["neighbor_keys"]], kind)
            return z["layer_ids"], keys, nbrs
    if fmt == "parquet":
        table = pq.read_table(path)
    elif fmt == "arrow":
        with pa_ipc.open_file(path) as f:
            table = f.read_all()
    else:
        raise ValueError(f"unknown format {fmt}")
    meta = table.schema.metadata or {}
    kind = (meta.get(b"key_kind") or b"int64").decode()
    return (np.asarray(table.column("layer_id").to_pylist(), np.int32),
            decode_keys(table.column("key").to_pylist(), kind),
            decode_keys(table.column("neighbor_key").to_pylist(), kind))


def write_metadata(path: str, payload: dict, fmt: str) -> None:
    blob = json.dumps(payload).encode()
    if fmt == "npz":
        _atomic_write(path, lambda p: np.savez_compressed(
            open(p, "wb"), blob=np.frombuffer(blob, np.uint8)))
        return
    table = pa.table({"json": pa.array([blob.decode()], pa.string())})
    if fmt == "parquet":
        _atomic_write(path, lambda p: pq.write_table(table, p))
    else:
        def w(p):
            with pa_ipc.new_file(p, table.schema) as f:
                f.write_table(table)
        _atomic_write(path, w)


def read_metadata(path: str, fmt: str) -> dict:
    if fmt == "npz":
        with np.load(path, allow_pickle=False) as z:
            return json.loads(bytes(z["blob"].tobytes()).decode())
    if fmt == "parquet":
        table = pq.read_table(path)
    else:
        with pa_ipc.open_file(path) as f:
            table = f.read_all()
    return json.loads(table.column("json")[0].as_py())


def ext_for(fmt: str) -> str:
    return {"parquet": "parquet", "arrow": "arrow", "npz": "npz"}[fmt]
