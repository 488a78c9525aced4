"""Image files: EXR (a self-contained scanline writer and reader), PNG and
Radiance HDR, in numpy.

Counterpart of `etx_tracer_tpu/utils/image_io.py`, which writes the same
bytes for the same array. PIZ goes through the native library
(`native/exr_decoder.cpp`); where it cannot be built, a PIZ write writes
ZIP and a PIZ read raises, as in the JAX package without its helper.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from etx_tracer_tpu_torch import native


def _flip(img: np.ndarray) -> np.ndarray:
  """Film arrays are bottom-up (NDC v); images are stored top-down."""
  return img[::-1]


# ---------------------------------------------------------------------------
# EXR (uncompressed scanline, float32, RGB)
# ---------------------------------------------------------------------------


_EXR_COMP_IDS = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4}


def _exr_predictor_interleave(d: np.ndarray) -> np.ndarray:
  """Encode-side inverse of _exr_predictor_deinterleave: split even/odd
  bytes, then delta-encode."""
  n = d.size
  half = (n + 1) // 2
  re = np.empty(n, np.uint8)
  re[:half] = d[0::2]
  re[half:] = d[1::2]
  out = np.empty(n, np.uint8)
  out[0] = re[0]
  out[1:] = ((re[1:].astype(np.int32) - re[:-1].astype(np.int32)) + 128) & 0xFF
  return out


def _exr_rle_encode(d: np.ndarray) -> bytes:
  out = bytearray()
  n = d.size
  i = 0
  while i < n:
    # measure run of equal bytes
    j = i + 1
    while j < n and d[j] == d[i] and j - i < 128:
      j += 1
    if j - i >= 3:
      out.append(j - i - 1)       # repeat count+1 times
      out.append(int(d[i]))
      i = j
    else:
      # literal run until the next >=3 repeat (max 128)
      k = i
      while k < n and k - i < 128:
        if k + 2 < n and d[k] == d[k + 1] == d[k + 2]:
          break
        k += 1
      out.append(256 - (k - i))   # negative count = literal
      out += d[i:k].tobytes()
      i = k
  return bytes(out)


def save_exr(path: str, image: np.ndarray, flip: bool = True,
             compression: str = "none", half: bool = False):
  """Write (H,W,3) float as a scanline EXR (B,G,R channels).

  compression: none|rle|zips|zip|piz (PIZ needs the native library; without
  it a PIZ write writes ZIP). half: write HALF instead of FLOAT pixels."""
  img = np.asarray(image, np.float32)
  if flip:
    img = _flip(img)
  h, w, _ = img.shape
  comp = _EXR_COMP_IDS[compression]
  if comp == 4 and native.load() is None:
    comp = 3  # no PIZ encoder: ZIP

  def attr(name, typ, data):
    return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(data)) + data

  ptype = _EXR_HALF if half else _EXR_FLOAT
  nb = 2 if half else 4
  channels = b""
  for ch in (b"B", b"G", b"R"):
    # name \0, pixelType i32, pLinear u8 + 3 reserved, xSampling, ySampling
    channels += ch + b"\x00" + struct.pack("<i", ptype) + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
  channels += b"\x00"

  header = b""
  header += attr("channels", "chlist", channels)
  header += attr("compression", "compression", bytes([comp]))
  header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
  header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
  header += attr("lineOrder", "lineOrder", b"\x00")
  header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
  header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
  header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
  header += b"\x00"

  block = _EXR_BLOCK_LINES[comp]
  n_chunks = (h + block - 1) // block
  dt = "<f2" if half else "<f4"

  chunks = []
  for c in range(n_chunks):
    y0c = c * block
    lines = min(block, h - y0c)
    raw = bytearray()
    for y in range(y0c, y0c + lines):
      row = img[y]
      raw += row[:, 2].astype(dt).tobytes()  # B
      raw += row[:, 1].astype(dt).tobytes()  # G
      raw += row[:, 0].astype(dt).tobytes()  # R
    raw = bytes(raw)
    if comp == 0:
      payload = raw
    elif comp == 1:
      payload = _exr_rle_encode(
          np.frombuffer(_exr_predictor_interleave(
              np.frombuffer(raw, np.uint8)).tobytes(), np.uint8))
    elif comp in (2, 3):
      payload = zlib.compress(_exr_predictor_interleave(
          np.frombuffer(raw, np.uint8)).tobytes(), 6)
    else:  # piz; None where the block does not compress: stored raw
      payload = native.piz_encode(raw, np.asarray([nb // 2] * 3, np.int32), w, lines) or raw
    if len(payload) >= len(raw):
      payload = raw
    chunks.append((y0c, payload))

  magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
  data_start = len(magic) + len(header) + n_chunks * 8
  offsets = bytearray()
  body = bytearray()
  pos = data_start
  for y0c, payload in chunks:
    offsets += struct.pack("<Q", pos)
    body += struct.pack("<ii", y0c, len(payload))
    body += payload
    pos += 8 + len(payload)

  with open(path, "wb") as f:
    f.write(magic + header + bytes(offsets) + bytes(body))


# EXR pixel types
_EXR_UINT, _EXR_HALF, _EXR_FLOAT = 0, 1, 2
# scanlines per chunk by compression id
_EXR_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}
_EXR_COMP_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                   5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _exr_parse_header(data: bytes):
  magic, version = struct.unpack("<ii", data[:8])
  if magic != 20000630:
    raise ValueError("not an EXR")
  if version & 0x200:
    raise ValueError("tiled EXR unsupported (scanline only)")
  if version & (0x800 | 0x1000):
    raise ValueError("deep/multipart EXR unsupported")
  pos = 8
  attrs = {}
  while data[pos] != 0:
    e = data.index(b"\x00", pos)
    name = data[pos:e].decode()
    pos = e + 1
    e = data.index(b"\x00", pos)
    typ = data[pos:e].decode()
    pos = e + 1
    size = struct.unpack("<i", data[pos:pos + 4])[0]
    pos += 4
    attrs[name] = (typ, data[pos:pos + size])
    pos += size
  return attrs, pos + 1


def _exr_parse_chlist(raw: bytes):
  """-> list of (name, pixel_type, x_sampling, y_sampling), file order."""
  chans = []
  pos = 0
  while raw[pos] != 0:
    e = raw.index(b"\x00", pos)
    name = raw[pos:e].decode()
    pos = e + 1
    ptype, _plinear, xs, ys = struct.unpack("<iiii", raw[pos:pos + 16])
    pos += 16
    chans.append((name, ptype, xs, ys))
  return chans


def _exr_predictor_deinterleave(b: np.ndarray) -> np.ndarray:
  """Shared ZIP/RLE post-pass: delta-decode then un-split even/odd bytes."""
  d = np.cumsum(np.concatenate([b[:1].astype(np.int64),
                                b[1:].astype(np.int64) - 128]))
  d = (d & 0xFF).astype(np.uint8)
  n = d.size
  half = (n + 1) // 2
  out = np.empty(n, np.uint8)
  out[0::2] = d[:half]
  out[1::2] = d[half:]
  return out


def _exr_rle_decode(src: bytes, out_size: int) -> np.ndarray:
  out = np.empty(out_size, np.uint8)
  i = o = 0
  n = len(src)
  while i < n and o < out_size:
    count = src[i]
    i += 1
    if count > 127:  # signed negative: literal run of 256-count bytes
      run = 256 - count
      out[o:o + run] = np.frombuffer(src, np.uint8, run, i)
      i += run
      o += run
    else:  # repeat next byte count+1 times
      out[o:o + count + 1] = src[i]
      i += 1
      o += count + 1
  if o != out_size:
    raise ValueError("corrupt RLE scanline")
  return out


def load_exr_channels(path: str) -> dict:
  """General single-part scanline EXR decode (tinyexr parity:
  reference render/host/image_pool.cxx:113): HALF/FLOAT/UINT channels;
  NONE/RLE/ZIPS/ZIP compression in numpy, PIZ through the native library
  (raises without it).

  Returns {"channels": {name: (H,W) float32 (or uint32 for UINT)},
           "size": (W, H)} with rows top-down as stored."""
  with open(path, "rb") as f:
    data = f.read()
  attrs, pos = _exr_parse_header(data)
  x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
  w, h = x1 - x0 + 1, y1 - y0 + 1
  comp = attrs["compression"][1][0]
  line_order = attrs.get("lineOrder", ("lineOrder", b"\x00"))[1][0]
  if comp not in _EXR_BLOCK_LINES:
    raise ValueError(
        f"EXR compression {_EXR_COMP_NAMES.get(comp, comp)} unsupported "
        "(NONE/RLE/ZIPS/ZIP/PIZ)")
  chans = _exr_parse_chlist(attrs["channels"][1])
  for name, ptype, xs, ys in chans:
    if xs != 1 or ys != 1:
      raise ValueError(f"subsampled channel {name!r} unsupported")
  block = _EXR_BLOCK_LINES[comp]
  n_chunks = (h + block - 1) // block
  # Chunk offset table: seek via the stored offsets (spec-legal files may
  # pad between chunks or store them out of table order).
  chunk_offsets = np.frombuffer(data, "<u8", n_chunks, pos)
  pos += n_chunks * 8

  ch_bytes = [2 if p == _EXR_HALF else 4 for _, p, _, _ in chans]
  line_bytes = sum(w * b for b in ch_bytes)
  planes = {name: np.zeros((h, w), np.float32 if p != _EXR_UINT else np.uint32)
            for name, p, _, _ in chans}

  for ci in range(n_chunks):
    pos = int(chunk_offsets[ci])
    yy, size = struct.unpack("<ii", data[pos:pos + 8])
    pos += 8
    payload = data[pos:pos + size]
    row0 = yy - y0
    lines = min(block, h - row0)
    raw_size = line_bytes * lines
    if comp == 0 or size == raw_size:
      raw = np.frombuffer(payload, np.uint8, raw_size)
    elif comp == 1:  # RLE
      raw = _exr_predictor_deinterleave(_exr_rle_decode(payload, raw_size))
    elif comp in (2, 3):  # ZIPS / ZIP
      raw = _exr_predictor_deinterleave(
          np.frombuffer(zlib.decompress(payload), np.uint8))
      if raw.size != raw_size:
        raise ValueError("corrupt ZIP block size")
    else:  # PIZ
      out = native.piz_decode(payload, np.asarray([b // 2 for b in ch_bytes], np.int32), w,
                              lines)
      if out is None:
        raise ValueError("PIZ EXR requires the native library (g++)")
      raw = np.frombuffer(out, np.uint8)

    off = 0
    for li in range(lines):
      y = row0 + li
      if line_order == 1:  # decreasing Y
        y = h - 1 - y
      for (name, ptype, _, _), nb in zip(chans, ch_bytes):
        seg = raw[off:off + w * nb]
        off += w * nb
        if ptype == _EXR_HALF:
          planes[name][y] = seg.view("<f2").astype(np.float32)
        elif ptype == _EXR_FLOAT:
          planes[name][y] = seg.view("<f4")
        else:
          planes[name][y] = seg.view("<u4")
  return {"channels": planes, "size": (w, h)}


def load_exr(path: str) -> np.ndarray:
  """Read any supported EXR -> (H,W,3) float32 RGB (top-down rows).

  Channel resolution: R/G/B planes if present; Y (luminance) replicated;
  otherwise the first three planes in file order."""
  d = load_exr_channels(path)
  planes = d["channels"]
  w, h = d["size"]
  if all(c in planes for c in ("R", "G", "B")):
    rgb = [planes["R"], planes["G"], planes["B"]]
  elif "Y" in planes:
    rgb = [planes["Y"]] * 3
  else:
    names = list(planes)[:3]
    while len(names) < 3:
      names.append(names[-1])
    rgb = [planes[n] for n in names]
  return np.stack([np.asarray(p, np.float32) for p in rgb], -1)


# ---------------------------------------------------------------------------
# PNG (8-bit sRGB)
# ---------------------------------------------------------------------------


def encode_png(image: np.ndarray, flip: bool = True, tonemap: bool = True,
               exposure: float = 1.0) -> bytes:
  """Encode (H,W,3) linear float as 8-bit sRGB PNG bytes."""
  img = np.asarray(image, np.float32) * exposure
  if flip:
    img = _flip(img)
  if tonemap:
    img = np.where(img <= 0.0031308, 12.92 * img,
                   1.055 * np.power(np.maximum(img, 0.0031308), 1 / 2.4) - 0.055)
  u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
  h, w, _ = u8.shape

  raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

  def chunk(tag, payload):
    c = tag + payload
    return struct.pack(">I", len(payload)) + c + struct.pack(">I", zlib.crc32(c))

  ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
  return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
          + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray, flip: bool = True, tonemap: bool = True):
  """Write (H,W,3) linear float as 8-bit sRGB PNG."""
  with open(path, "wb") as f:
    f.write(encode_png(image, flip=flip, tonemap=tonemap))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
  """Reference-image comparison metric (the de-facto regression test in the
  reference viewer's diff modes, raytracer/options.hxx:9-18)."""
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64)
  return float(np.sqrt(np.mean((a - b) ** 2)))


# ---------------------------------------------------------------------------
# PNG decode (8/16-bit RGB(A)/gray, non-interlaced)
# ---------------------------------------------------------------------------


def load_png(path: str) -> np.ndarray:
  """Decode PNG -> (H,W,4) float32 linear-ish [0,1] (no sRGB conversion)."""
  with open(path, "rb") as f:
    data = f.read()
  return decode_png(data)


def decode_png(data: bytes) -> np.ndarray:
  """Decode PNG bytes -> (H,W,4) float32 [0,1] (no sRGB conversion).

  Split out from load_png so in-memory sources (glTF bufferView images,
  data: URIs) share the codec."""
  assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
  pos = 8
  idat = b""
  w = h = bit_depth = color_type = None
  palette = None
  while pos < len(data):
    (length,) = struct.unpack(">I", data[pos:pos + 4])
    tag = data[pos + 4:pos + 8]
    payload = data[pos + 8:pos + 8 + length]
    pos += 12 + length
    if tag == b"IHDR":
      w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
      assert interlace == 0, "interlaced PNG unsupported"
    elif tag == b"PLTE":
      palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
    elif tag == b"IDAT":
      idat += payload
    elif tag == b"IEND":
      break
  raw = zlib.decompress(idat)

  channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
  bpp_bits = channels * bit_depth
  stride_bits = w * bpp_bits
  stride = (stride_bits + 7) // 8
  fbpp = max(1, bpp_bits // 8)

  out = np.zeros((h, stride), np.uint8)
  prev = np.zeros(stride, np.int32)
  pos = 0
  for y in range(h):
    ftype = raw[pos]
    line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32).copy()
    pos += 1 + stride
    if ftype == 0:
      cur = line
    elif ftype == 1:
      cur = line
      for x in range(fbpp, stride):
        cur[x] = (cur[x] + cur[x - fbpp]) & 0xFF
    elif ftype == 2:
      cur = (line + prev) & 0xFF
    elif ftype == 3:
      cur = line
      for x in range(stride):
        left = cur[x - fbpp] if x >= fbpp else 0
        cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
    elif ftype == 4:
      cur = line
      for x in range(stride):
        a = cur[x - fbpp] if x >= fbpp else 0
        b = prev[x]
        c = prev[x - fbpp] if x >= fbpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[x] = (cur[x] + pr) & 0xFF
    else:
      raise ValueError(f"bad PNG filter {ftype}")
    out[y] = cur.astype(np.uint8)
    prev = cur

  if bit_depth == 8:
    img = out[:, :w * channels].reshape(h, w, channels).astype(np.float32) / 255.0
  elif bit_depth == 16:
    b16 = out.view(">u2" if False else np.uint8)
    arr = (out[:, 0:2 * w * channels:2].astype(np.uint16) << 8) | out[:, 1:2 * w * channels:2]
    img = arr.reshape(h, w, channels).astype(np.float32) / 65535.0
  else:
    raise ValueError(f"bit depth {bit_depth} unsupported")

  if color_type == 3:  # palette
    assert palette is not None
    ids = (img[..., 0] * 255.0 + 0.5).astype(np.int32)
    img = palette[ids].astype(np.float32) / 255.0

  if img.shape[-1] == 1:
    img = np.repeat(img, 3, axis=-1)
  if img.shape[-1] == 2:  # gray+alpha
    a = img[..., 1:2]
    img = np.concatenate([np.repeat(img[..., :1], 3, -1), a], -1)
  if img.shape[-1] == 3:
    img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
  return img.astype(np.float32)


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr / .pic) decode — RGBE with optional scanline RLE
# ---------------------------------------------------------------------------


def load_hdr(path: str) -> np.ndarray:
  with open(path, "rb") as f:
    data = f.read()
  pos = data.index(b"\n\n") + 2 if b"\n\n" in data[:2000] else 0
  if pos == 0:
    # header lines end at an empty line
    lines_end = data.index(b"\n\n") + 2
    pos = lines_end
  # resolution line
  eol = data.index(b"\n", pos)
  res = data[pos:eol].decode().split()
  pos = eol + 1
  assert res[0] == "-Y" and res[2] == "+X", f"unsupported orientation {res}"
  h, w = int(res[1]), int(res[3])
  img = np.zeros((h, w, 4), np.uint8)
  for y in range(h):
    if data[pos] == 2 and data[pos + 1] == 2 and ((data[pos + 2] << 8) | data[pos + 3]) == w:
      pos += 4
      row = np.zeros((4, w), np.uint8)
      for ch in range(4):
        x = 0
        while x < w:
          count = data[pos]; pos += 1
          if count > 128:
            row[ch, x:x + count - 128] = data[pos]; pos += 1
            x += count - 128
          else:
            row[ch, x:x + count] = np.frombuffer(data[pos:pos + count], np.uint8)
            pos += count
            x += count
      img[y] = row.T
    else:  # flat RGBE
      row = np.frombuffer(data[pos:pos + 4 * w], np.uint8).reshape(w, 4)
      img[y] = row
      pos += 4 * w
  rgbe = img.astype(np.float32)
  e = np.ldexp(1.0, img[..., 3].astype(np.int32) - 136)  # 128 + 8 mantissa bits
  rgb = rgbe[..., :3] * e[..., None]
  rgb[img[..., 3] == 0] = 0.0
  return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1).astype(np.float32)


def srgb_image_to_linear(img: np.ndarray) -> np.ndarray:
  """(H,W,4) sRGB-encoded RGB + linear alpha -> all-linear float32."""
  rgb = img[..., :3]
  return np.concatenate([
      np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4),
      img[..., 3:4]], -1).astype(np.float32)


def load_image(path: str, srgb_to_linear: bool = True) -> np.ndarray:
  """Load PNG/HDR/EXR into (H,W,4) float32 linear, top-down rows."""
  low = path.lower()
  if low.endswith(".png"):
    img = load_png(path)
    if srgb_to_linear:
      img = srgb_image_to_linear(img)
    return img
  if low.endswith((".hdr", ".pic")):
    return load_hdr(path)
  if low.endswith(".exr"):
    rgb = load_exr(path)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
  raise ValueError(f"unsupported image format: {path}")
