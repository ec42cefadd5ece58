"""GIF89a writer for turntable animations.

Counterpart of the vendored ``gif-h`` used by the reference
(``tests/main.cpp:77-115``).  Like gif-h, every frame gets an **adaptive
per-frame palette** (median cut over the frame's 15-bit color histogram,
nearest-color mapping through a 32^3 LUT) written as a local color table —
smooth volumetric gradients don't band the way a fixed color cube does.
Two backends:

* native C++ encoder (gvr/native, full LZW) when built;
* pure-Python fallback emitting the *literal-code* LZW stream (every pixel
  as its own 9-bit code with periodic clear codes).  The literal stream is
  valid LZW that any decoder accepts; it trades file size for
  fully-vectorized numpy encoding — no per-pixel Python loop.
"""

from __future__ import annotations

import numpy as np

from gvr.native import loader as _native


def write_gif(path: str, frames, delay_cs: int = 3) -> None:
    """frames: iterable of float [H,W,3] images in [0,1]."""
    from gvr.io.ppm import quantize

    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = np.asarray(frames[0]).shape[:2]

    nat = _native.lib()
    use_native = nat is not None
    handle = nat.gif_begin(path, w, h, delay_cs) if use_native else None
    if use_native and not handle:
        use_native = False

    if use_native:
        ok = True
        indexed = nat.has_indexed_gif
        for fr in frames:
            u8 = quantize(np.asarray(fr))
            if indexed:
                pal = adaptive_palette(u8)
                idx = palette_indices(u8, pal)
                ok = ok and nat.gif_frame_indexed(handle, idx, pal)
            else:
                # legacy native lib (predates gvr_gif_frame_indexed): its
                # fixed-palette LZW path still beats the Python
                # literal-code stream on file size
                rgba = np.concatenate(
                    [u8, np.full(u8.shape[:2] + (1,), 255, np.uint8)],
                    axis=-1)
                ok = ok and nat.gif_frame(handle, rgba)
        ok = nat.gif_end(handle) and ok
        if ok:
            return

    _write_gif_python(path, frames, w, h, delay_cs)


# -----------------------------------------------------------------------------
# Adaptive palette (median cut), the gif-h quality model
# -----------------------------------------------------------------------------

def adaptive_palette(u8: np.ndarray, n_colors: int = 256) -> np.ndarray:
    """Median-cut palette [256,3] uint8 for one frame.

    Operates on the 15-bit (5/5/5) color histogram: boxes are repeatedly
    split at the count-weighted median of their widest axis; each box's
    color is its count-weighted mean.  Fully vectorized per split."""
    q = (u8.reshape(-1, 3) >> 3).astype(np.int32)
    codes = (q[:, 0] << 10) | (q[:, 1] << 5) | q[:, 2]
    uniq, counts = np.unique(codes, return_counts=True)
    cols = np.stack([(uniq >> 10) & 31, (uniq >> 5) & 31, uniq & 31],
                    axis=-1).astype(np.float32)
    w = counts.astype(np.float64)

    boxes = [np.arange(uniq.size)]
    while len(boxes) < n_colors:
        # split the box with the largest weighted extent
        best, best_score, best_axis = -1, 0.0, 0
        for i, b in enumerate(boxes):
            if b.size < 2:
                continue
            ext = cols[b].max(axis=0) - cols[b].min(axis=0)
            axis = int(ext.argmax())
            score = float(ext[axis]) * float(w[b].sum())
            if score > best_score:
                best, best_score, best_axis = i, score, axis
        if best < 0:
            break
        b = boxes[best]
        order = b[np.argsort(cols[b, best_axis], kind="stable")]
        cw = np.cumsum(w[order])
        split = int(np.searchsorted(cw, cw[-1] * 0.5)) + 1
        split = min(max(split, 1), b.size - 1)
        boxes[best] = order[:split]
        boxes.append(order[split:])

    pal = np.zeros((256, 3), np.uint8)
    for i, b in enumerate(boxes):
        c = (cols[b] * w[b, None]).sum(axis=0) / w[b].sum()
        pal[i] = np.clip(c * 8.0 + 4.0, 0, 255).astype(np.uint8)
    return pal


def palette_indices(u8: np.ndarray, pal: np.ndarray) -> np.ndarray:
    """Nearest-palette-color indices [H,W] uint8 via a 32^3 LUT (one
    32768 x 256 distance table per frame, then a pure table lookup)."""
    grid = np.stack(np.meshgrid(*([np.arange(32)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float32) * 8.0 + 4.0
    # |g-p|^2 = |g|^2 - 2 g.p + |p|^2 via one [32768,3]@[3,256] matmul:
    # ~32 MB peak instead of the ~100 MB [32768,256,3] broadcast temporary
    palf = pal.astype(np.float32)
    d = ((grid * grid).sum(-1, keepdims=True) - 2.0 * (grid @ palf.T)
         + (palf * palf).sum(-1)[None])
    lut = d.argmin(axis=1).astype(np.uint8)                   # [32768]
    q = (u8 >> 3).astype(np.int32)
    return lut[(q[..., 0] << 10) | (q[..., 1] << 5) | q[..., 2]]


# -----------------------------------------------------------------------------
# Pure-Python backend
# -----------------------------------------------------------------------------

def _palette_676():
    """6x7x6 RGB cube -> 252 colors, padded to 256."""
    r = np.linspace(0, 255, 6).round().astype(np.uint8)
    g = np.linspace(0, 255, 7).round().astype(np.uint8)
    b = np.linspace(0, 255, 6).round().astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    idx = 0
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1).reshape(-1, 3)
    pal[: grid.shape[0]] = grid
    return pal


def _lzw_literal_stream(indices: np.ndarray) -> bytes:
    """Encode 8-bit palette indices as a 9-bit literal LZW code stream.

    min_code_size = 8 -> CLEAR = 256, END = 257, first dict code 258.
    Emitting CLEAR every 254 literals keeps every code at 9 bits (the
    dictionary never reaches 512), so the bitstream can be packed with pure
    numpy."""
    px = indices.reshape(-1).astype(np.uint32)
    n = px.size
    block = 254
    nblocks = (n + block - 1) // block
    # codes: CLEAR, px[0:254], CLEAR, px[254:508], ..., END
    ncodes = n + nblocks + 1
    codes = np.empty(ncodes, np.uint32)
    pos = 0
    for i in range(nblocks):
        codes[pos] = 256
        chunk = px[i * block : (i + 1) * block]
        codes[pos + 1 : pos + 1 + chunk.size] = chunk
        pos += 1 + chunk.size
    codes[pos] = 257
    pos += 1
    codes = codes[:pos]

    bitpos = np.arange(codes.size, dtype=np.int64) * 9
    byte_idx = bitpos >> 3
    shift = (bitpos & 7).astype(np.uint32)
    val = codes << shift                      # < 2^16
    nbytes = int((codes.size * 9 + 7) // 8) + 1
    buf = np.zeros(nbytes, np.uint8)
    np.add.at(buf, byte_idx, (val & 0xFF).astype(np.uint8))
    np.add.at(buf, byte_idx + 1, (val >> 8).astype(np.uint8))
    total = (codes.size * 9 + 7) // 8
    return buf[:total].tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i : i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def _write_gif_python(path, frames, w, h, delay_cs):
    from gvr.io.ppm import quantize

    with open(path, "wb") as f:
        f.write(b"GIF89a")
        # logical screen descriptor: global color table, 8-bit, 256 entries
        f.write(np.array([w, h], "<u2").tobytes())
        f.write(bytes([0xF7, 0, 0]))
        f.write(_palette_676().tobytes())
        # netscape looping extension
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for fr in frames:
            u8 = quantize(np.asarray(fr))
            pal = adaptive_palette(u8)
            idx = palette_indices(u8, pal)
            # graphic control extension
            f.write(b"\x21\xf9\x04\x04")
            f.write(np.array([delay_cs], "<u2").tobytes())
            f.write(b"\x00\x00")
            # image descriptor with a local color table (adaptive per frame)
            f.write(b"\x2c")
            f.write(np.array([0, 0, w, h], "<u2").tobytes())
            f.write(bytes([0x87]))
            f.write(pal.tobytes())
            # LZW min code size + data sub-blocks
            f.write(bytes([8]))
            f.write(_sub_blocks(_lzw_literal_stream(idx)))
        f.write(b"\x3b")
