"""Checkpointing in the JAX package's format: a directory holding
``arrays.npz`` (one array per leaf, named by its path) and
``manifest.msgpack`` (``step``, ``meta``, ``keys``, ``shapes``, ``dtypes``).

A leaf's name joins its path with "/": dict keys, sequence indices, and a
NamedTuple field as ".name" (JAX's ``GetAttrKey``), so the two packages
read each other's fp32 checkpoints. A bf16 leaf is stored as its raw 16
bits (numpy's 2-byte void, as numpy saves JAX's bfloat16 arrays) with
"bfloat16" in the manifest. The port depends on torch, numpy and the
standard library only, so the manifest's subset of msgpack (maps,
strings, integers, floats, lists, booleans and nil) is encoded and
decoded here. Restore checks the target
tree's keys and shapes and puts each leaf in the target's dtype and on its
device.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optimizer import tree_unflatten

BF16_BITS = np.dtype("V2")  # how numpy stores a bfloat16 element


def _paths(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _paths(item, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.uint16).numpy().view(BF16_BITS), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree: Any, step: int = 0, meta: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in _paths(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "meta": meta or {},
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16" or arr.dtype == BF16_BITS:
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load(path: str, target_tree: Any) -> Any:
    """Restore into the structure of ``target_tree`` (keys and shapes
    checked), each leaf in its target's dtype and on its device."""
    manifest = read_manifest(path)
    dtypes = manifest.get("dtypes", {})
    arrays = np.load(os.path.join(path, "arrays.npz"))
    leaves = []
    for key, leaf in _paths(target_tree):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs target {tuple(leaf.shape)}"
            )
        leaves.append(_from_numpy(arr, dtypes.get(key)).to(device=leaf.device,
                                                            dtype=leaf.dtype))
    return tree_unflatten(target_tree, leaves)


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return unpackb(f.read())


def latest_step(path: str) -> int:
    return read_manifest(path)["step"]


# ---------------------------------------------------------------------------
# msgpack, the manifest's subset (msgpack-python's packb/unpackb encoding)
# ---------------------------------------------------------------------------
def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        n = int(obj)
        if 0 <= n < 0x80:
            out.append(n)
        elif -32 <= n < 0:
            out.append(n & 0xFF)
        elif n >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if n < top:
                    out.append(code)
                    out += struct.pack(fmt, n)
                    return
            raise OverflowError(f"{n} does not fit msgpack's uint64")
        else:
            for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                   (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if n >= low:
                    out.append(code)
                    out += struct.pack(fmt, n)
                    return
            raise OverflowError(f"{n} does not fit msgpack's int64")
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCB)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the manifest codec takes no {type(obj).__name__}")


def _header(out: bytearray, n: int, fix: int, fix_limit: int, codes) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form (codes, None where the type has no 8-bit form)."""
    if n < fix_limit:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def unpackb(data: bytes):
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes after the manifest ({len(data) - pos})")
    return obj


_FIXED = {  # code: (struct format, size)
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}


def _length(data: bytes, pos: int, size: int) -> Tuple[int, int]:
    fmt = {1: ">B", 2: ">H", 4: ">I"}[size]
    return struct.unpack_from(fmt, data, pos)[0], pos + size


def _unpack(data: bytes, pos: int):
    code = data[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    if 0xA0 <= code <= 0xBF or code in (0xD9, 0xDA, 0xDB):
        n, pos = ((code & 0x1F), pos) if code <= 0xBF else _length(
            data, pos, {0xD9: 1, 0xDA: 2, 0xDB: 4}[code])
        return data[pos:pos + n].decode("utf-8"), pos + n
    if 0x90 <= code <= 0x9F or code in (0xDC, 0xDD):
        n, pos = ((code & 0x0F), pos) if code <= 0x9F else _length(
            data, pos, {0xDC: 2, 0xDD: 4}[code])
        items: List[Any] = []
        for _ in range(n):
            item, pos = _unpack(data, pos)
            items.append(item)
        return items, pos
    if 0x80 <= code <= 0x8F or code in (0xDE, 0xDF):
        n, pos = ((code & 0x0F), pos) if code <= 0x8F else _length(
            data, pos, {0xDE: 2, 0xDF: 4}[code])
        out: Dict[Any, Any] = {}
        for _ in range(n):
            k, pos = _unpack(data, pos)
            out[k], pos = _unpack(data, pos)
        return out, pos
    raise ValueError(f"msgpack type 0x{code:02x} is outside the manifest's subset")
