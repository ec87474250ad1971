"""One buffer in, one array out: the dispatch transport of the streamed farm.

Counterpart of ``vlfm_tpu/runner/packing.py``. Every host-to-device field
of a farm dispatch (depth, RGB or the oracle's cosine and mask bits, pose,
seeds, steps, reset flags) is written into one preallocated uint8 buffer
(``pack_views`` gives writable numpy views into it), which crosses to the
card in one copy; the fused step reads each field back as a typed view of
the device buffer (``unpack_device``: a slice, ``view(dtype)`` and a
reshape, bit-exact and without a copy), and returns its outputs packed into
one (B, 4) f32 tensor, read back in one copy.

Offsets are aligned to ``max(4, itemsize)``: ``Tensor.view(dtype)`` on a
uint8 slice needs a storage offset that is a multiple of the item size. For
fields of 1, 2 and 4 bytes, the only ones the farm builds, that is JAX's
4-byte alignment, so the offsets are JAX's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np


class Field(NamedTuple):
    name: str
    dtype: str  # numpy dtype name, e.g. "float32"
    shape: Tuple[int, ...]
    offset: int  # bytes, a multiple of max(4, itemsize)
    nbytes: int


class Layout(NamedTuple):
    fields: Tuple[Field, ...]
    total: int  # buffer bytes

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


def build_layout(specs: Sequence[Tuple[str, str, Tuple[int, ...]]]) -> Layout:
    """specs: (name, numpy dtype name, shape), laid out in order."""
    fields: List[Field] = []
    off = 0
    for name, dtype, shape in specs:
        itemsize = np.dtype(dtype).itemsize
        align = max(4, itemsize)
        off = -(-off // align) * align
        nbytes = int(itemsize * np.prod(shape, dtype=np.int64))
        fields.append(Field(name, dtype, tuple(int(s) for s in shape), off, nbytes))
        off += nbytes
    return Layout(tuple(fields), -(-off // 4) * 4)


def pack_views(buf: np.ndarray, layout: Layout) -> Dict[str, np.ndarray]:
    """Writable typed views into a (total,) uint8 buffer: fill them in place
    each dispatch, with no copy beyond the field writes."""
    if buf.dtype != np.uint8 or buf.shape != (layout.total,):
        raise ValueError(f"need a ({layout.total},) uint8 buffer, got {buf.shape} {buf.dtype}")
    return {
        f.name: buf[f.offset:f.offset + f.nbytes].view(f.dtype).reshape(f.shape)
        for f in layout.fields
    }


def unpack_device(layout: Layout, buf):
    """{name: typed view} of a (total,) uint8 tensor, on the tensor's own
    device: ``buf[off:off + n].view(dtype).reshape(shape)``, no copy. uint8
    fields come back as they are (the caller casts flags to bool)."""
    import torch

    if buf.dtype != torch.uint8 or tuple(buf.shape) != (layout.total,):
        raise ValueError(f"need a ({layout.total},) uint8 tensor, got {tuple(buf.shape)} {buf.dtype}")
    return {
        f.name: buf[f.offset:f.offset + f.nbytes].view(getattr(torch, f.dtype)).reshape(f.shape)
        for f in layout.fields
    }
