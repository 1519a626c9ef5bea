"""Image file I/O: PPM/PGM (ascii + binary) and optional PNG.

The port's own copy of infinitam_tpu/utils/image_io.py; tests/test_torch_io.py
holds the two byte for byte. Reference parity:
InfiniTAM/Utils/FileUtils.cpp:251-424 (ReadImageFromFile / SaveImageToFile
for uchar4 rgb, short depth, float images). The reference's dataset format
is printf-masked `%04i.ppm` (rgb) / `%04i.pgm` (16-bit depth).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np


def _read_pnm_header(f) -> tuple[bytes, int, int, int]:
    """Parse P2/P3/P5/P6 header, returning (magic, width, height, maxval)."""
    magic = f.read(2)
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"not a supported PNM file (magic={magic!r})")
    vals = []
    while len(vals) < 3:
        line = f.readline()
        if not line:
            raise ValueError("truncated PNM header")
        line = line.split(b"#", 1)[0]
        vals.extend(int(tok) for tok in line.split())
    w, h, maxval = vals[:3]
    return magic, w, h, maxval


def read_pgm(path: str) -> np.ndarray:
    """Read a PGM (grey/depth) image. 16-bit big-endian per PNM spec → uint16,
    8-bit → uint8. Returns array of shape [H, W]."""
    with open(path, "rb") as f:
        magic, w, h, maxval = _read_pnm_header(f)
        if magic == b"P2":  # ascii
            data = np.array(f.read().split(), dtype=np.int64)
            arr = data.reshape(h, w)
            return arr.astype(np.uint16 if maxval > 255 else np.uint8)
        dtype = ">u2" if maxval > 255 else np.uint8
        raw = np.frombuffer(f.read(w * h * (2 if maxval > 255 else 1)), dtype=dtype)
        return raw.reshape(h, w).astype(np.uint16 if maxval > 255 else np.uint8)


def read_ppm(path: str) -> np.ndarray:
    """Read a PPM (rgb) image → uint8 array [H, W, 3]."""
    with open(path, "rb") as f:
        magic, w, h, maxval = _read_pnm_header(f)
        if magic == b"P3":  # ascii
            data = np.array(f.read().split(), dtype=np.int64)
            return data.reshape(h, w, 3).astype(np.uint8)
        raw = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
        return raw.reshape(h, w, 3)


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write uint8 or uint16 [H, W] as binary PGM (16-bit big-endian)."""
    img = np.asarray(img)
    h, w = img.shape
    if img.dtype == np.uint16 or img.max(initial=0) > 255:
        img = img.astype(np.uint16)
        header = f"P5\n{w} {h}\n65535\n".encode()
        payload = img.astype(">u2").tobytes()
    else:
        img = img.astype(np.uint8)
        header = f"P5\n{w} {h}\n255\n".encode()
        payload = img.tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] (or [H, W, 4], alpha dropped) as binary PPM."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def read_image(path: str) -> np.ndarray:
    """Dispatch on extension; PNG requires PIL (optional)."""
    lower = path.lower()
    if lower.endswith(".pgm"):
        return read_pgm(path)
    if lower.endswith(".ppm"):
        return read_ppm(path)
    if lower.endswith(".png"):
        try:
            from PIL import Image  # optional dependency
        except ImportError as e:  # pragma: no cover
            raise ImportError("PNG support requires PIL") from e
        return np.asarray(Image.open(path))
    raise ValueError(f"unsupported image extension: {path}")


def write_png(path: str, img: np.ndarray) -> None:
    """PNG writer with a pure-stdlib (zlib) fallback — uint8 grey/RGB/RGBA
    and uint16 grey (reference: FileUtils.cpp:251-424 covers PNG both ways
    via libpng; here PIL when present, else a minimal encoder)."""
    img = np.asarray(img)
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return
    except ImportError:  # pragma: no cover - exercised when PIL is absent
        pass
    import struct
    import zlib

    if img.ndim == 2:
        color_type = 0
        planes = img[:, :, None]
    elif img.shape[2] == 3:
        color_type = 2
        planes = img
    elif img.shape[2] == 4:
        color_type = 6
        planes = img
    else:
        raise ValueError(f"unsupported channel count {img.shape}")
    if img.dtype == np.uint16:
        depth = 16
        raw = planes.astype(">u2").tobytes()
        stride = planes.shape[1] * planes.shape[2] * 2
    else:
        depth = 8
        raw = planes.astype(np.uint8).tobytes()
        stride = planes.shape[1] * planes.shape[2]
    rows = b"".join(
        b"\x00" + raw[y * stride:(y + 1) * stride] for y in range(planes.shape[0])
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(
        ">IIBBBBB", planes.shape[1], planes.shape[0], depth, color_type, 0, 0, 0
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows, 6)))
        f.write(chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray) -> None:
    lower = path.lower()
    if lower.endswith(".pgm"):
        write_pgm(path, img)
    elif lower.endswith(".ppm"):
        write_ppm(path, img)
    elif lower.endswith(".png"):
        write_png(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


def expand_printf_mask(mask: str, index: int) -> str:
    """Expand a C printf-style mask like `%04i.ppm` (reference:
    ImageSourceEngine.cpp ImageMaskPathGenerator)."""
    return re.sub(
        r"%0?(\d*)[di]",
        lambda m: str(index).zfill(int(m.group(1) or "0")),
        mask,
    )
