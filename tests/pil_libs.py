"""Writers and readers from the C libraries PIL 12.1 bundles
(``pillow.libs/``), called through ``ctypes``, for inputs that PIL's own
API does not write and for probing what libtiff itself reads:

- ``tiff_write``: libtiff's writer (``TIFFSetField``,
  ``TIFFWriteEncodedStrip`` and ``TIFFWriteEncodedTile``), for JPEG-in-TIFF
  in planes and at 12 bits;
- ``tiff_read_rgba``: libtiff's RGBA interface (``TIFFReadRGBAStrip`` and
  ``TIFFReadRGBATile``), which PIL reads YCbCr TIFF with;
- ``webp_encode``: libwebp's ``WebPEncode`` with the loop filter and
  partition settings that PIL's save does not take.

A library that is missing raises: the tests that use these fail rather
than skip."""

import ctypes
import glob
import os

import numpy as np
import PIL
from PIL import Image  # noqa: F401  (loads the libraries libtiff links against)

LIBS = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")


def _lib(stem: str, mode: int = ctypes.DEFAULT_MODE) -> ctypes.CDLL:
    found = sorted(glob.glob(os.path.join(LIBS, f"{stem}-*.so*")))
    if not found:
        raise FileNotFoundError(f"PIL's bundled {stem} is not in {LIBS}")
    return ctypes.CDLL(found[0], mode=mode)


def _libtiff() -> ctypes.CDLL:
    lib = _lib("libtiff")
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFSetField.restype = ctypes.c_int
    for name in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                       ctypes.c_ssize_t]
        getattr(lib, name).restype = ctypes.c_ssize_t
    lib.TIFFReadRGBAStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
    lib.TIFFReadRGBATile.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                     ctypes.c_void_p]
    return lib


def pack12(v: np.ndarray) -> bytes:
    """(rows, n) 12-bit samples, n even, packed two in three bytes most
    significant bit first: the layout libtiff's 12-bit JPEG codec takes and
    gives."""
    v = v.astype(np.uint32).reshape(v.shape[0], -1)
    a, b = v[:, 0::2], v[:, 1::2]
    return np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).astype(np.uint8).tobytes()


def tiff_write(path: str, img: np.ndarray, photo: int, comp: int = 7, bits: int = 8,
               planar: int = 1, rows=None, tile=None, extra=(), sub=None,
               quality: int = 75) -> str:
    """A TIFF of (h, w[, spp]) samples written by libtiff: strips of
    ``rows`` rows or ``tile`` (length, width) tiles, chunky or in planes,
    ExtraSamples ``extra``, YCbCrSubsampling ``sub``, JPEG ``quality``."""
    lib = _libtiff()
    img = img if img.ndim == 3 else img[:, :, None]
    h, w, spp = img.shape
    t = lib.TIFFOpen(path.encode(), b"w")
    if not t:
        raise OSError(f"libtiff cannot open {path}")
    i = ctypes.c_int

    def put(tag, *vals):
        if lib.TIFFSetField(ctypes.c_void_p(t), i(tag), *vals) != 1:
            raise ValueError(f"libtiff refuses tag {tag} = {vals}")

    try:
        for tag, v in ((256, w), (257, h), (258, bits), (277, spp), (259, comp), (262, photo),
                       (284, planar)):
            put(tag, i(v))
        if extra:
            put(338, i(len(extra)), (ctypes.c_uint16 * len(extra))(*extra))
        if sub:
            put(530, i(sub[0]), i(sub[1]))
        if tile:
            put(322, i(tile[1]))
            put(323, i(tile[0]))
        else:
            put(278, i(rows or h))
        if comp == 7:
            put(65537, i(quality))  # TIFFTAG_JPEGQUALITY
        step = tile or (rows or h, w)
        k = 0
        for p in range(spp) if planar == 2 else [None]:
            for y in range(0, h, step[0]):
                for x in range(0, w, step[1]) if tile else [0]:
                    part = img[y:y + step[0], x:x + step[1]]
                    if tile:
                        full = np.zeros(tile + (spp,), img.dtype)
                        full[:part.shape[0], :part.shape[1]] = part
                        part = full
                    part = part if p is None else part[:, :, p:p + 1]
                    raw = (pack12(part.reshape(part.shape[0], -1)) if bits == 12 else
                           np.ascontiguousarray(part.astype(np.uint8)).tobytes())
                    write = lib.TIFFWriteEncodedTile if tile else lib.TIFFWriteEncodedStrip
                    if write(ctypes.c_void_p(t), k, raw, len(raw)) < 0:
                        raise ValueError(f"libtiff fails to write block {k} of {path}")
                    k += 1
    finally:
        lib.TIFFClose(ctypes.c_void_p(t))
    return path


def tiff_read_rgba(path: str, block: int, tile=None) -> np.ndarray:
    """libtiff's ``TIFFReadRGBAStrip`` (``tile`` None: strip ``block``) or
    ``TIFFReadRGBATile`` (``tile`` (length, width), block its index in rows
    of tiles) of ``path``, not stopping on errors: the (rows, width, 4)
    raster top row first, as PIL takes it."""
    lib = _libtiff()
    t = lib.TIFFOpen(path.encode(), b"r")
    if not t:
        raise OSError(f"libtiff cannot open {path}")
    try:
        with Image.open(path) as im:
            (w, h), rows = im.size, im.tag_v2.get(278, im.size[1])
        if tile:
            th, tw = tile
            across = -(-w // tw)
            buf = (ctypes.c_uint32 * (th * tw))()
            lib.TIFFReadRGBATile(ctypes.c_void_p(t), (block % across) * tw,
                                 (block // across) * th, buf)
            out = np.frombuffer(buf, np.uint8).reshape(th, tw, 4)
        else:
            buf = (ctypes.c_uint32 * (rows * w))()
            lib.TIFFReadRGBAStrip(ctypes.c_void_p(t), block * rows, buf)
            n = min(rows, h - block * rows)
            out = np.frombuffer(buf, np.uint8).reshape(rows, w, 4)[:n]
        return out[::-1].copy()  # libtiff's raster is bottom-up
    finally:
        lib.TIFFClose(ctypes.c_void_p(t))


class WebPConfig(ctypes.Structure):
    """libwebp 1.6's ``WebPConfig``: 24 ints and floats in its order, then
    three reserved ints."""
    _fields_ = [("lossless", ctypes.c_int), ("quality", ctypes.c_float),
                ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
                ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float),
                ("segments", ctypes.c_int), ("sns_strength", ctypes.c_int),
                ("filter_strength", ctypes.c_int), ("filter_sharpness", ctypes.c_int),
                ("filter_type", ctypes.c_int), ("autofilter", ctypes.c_int),
                ("alpha_compression", ctypes.c_int), ("alpha_filtering", ctypes.c_int),
                ("alpha_quality", ctypes.c_int), ("pass_", ctypes.c_int),
                ("show_compressed", ctypes.c_int), ("preprocessing", ctypes.c_int),
                ("partitions", ctypes.c_int), ("partition_limit", ctypes.c_int),
                ("emulate_jpeg_size", ctypes.c_int), ("thread_level", ctypes.c_int),
                ("low_memory", ctypes.c_int), ("near_lossless", ctypes.c_int),
                ("exact", ctypes.c_int), ("use_delta_palette", ctypes.c_int),
                ("use_sharp_yuv", ctypes.c_int), ("qmin", ctypes.c_int),
                ("qmax", ctypes.c_int), ("spare", ctypes.c_int * 16)]


class WebPPicture(ctypes.Structure):
    """libwebp 1.6's ``WebPPicture``, its padding fields kept, room after."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2), ("spare", ctypes.c_void_p * 16)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1),
                ("spare", ctypes.c_void_p * 4)]


# libwebp's ABI versions of encode.h (1.6): WEBP_ENCODER_ABI_VERSION 0x0210
_ENCODER_ABI = 0x0210


def webp_encode(rgb: np.ndarray, quality: float = 80, **settings) -> bytes:
    """A lossy WebP of (h, w, 3) uint8 ``rgb`` by libwebp's ``WebPEncode``
    with the ``WebPConfig`` fields in ``settings`` (``filter_type`` 0: the
    simple loop filter, ``filter_strength``, ``filter_sharpness``,
    ``partitions``, ``segments``, ...)."""
    _lib("libsharpyuv", ctypes.RTLD_GLOBAL)
    lib = _lib("libwebp")
    config, pic, wrt = WebPConfig(), WebPPicture(), WebPMemoryWriter()
    lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, ctypes.c_float(quality),
                                      _ENCODER_ABI):
        raise ValueError("libwebp refuses its config's version")
    for name, value in settings.items():
        setattr(config, name, value)
    lib.WebPValidateConfig.argtypes = [ctypes.c_void_p]
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the settings {settings}")
    lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ENCODER_ABI):
        raise ValueError("libwebp refuses its picture's version")
    h, w, _ = rgb.shape
    pic.width, pic.height = w, h
    data = np.ascontiguousarray(rgb, np.uint8)
    lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    if not lib.WebPPictureImportRGB(ctypes.byref(pic), data.ctypes.data, 3 * w):
        raise ValueError("libwebp cannot import the picture")
    lib.WebPMemoryWriterInit.argtypes = [ctypes.c_void_p]
    lib.WebPMemoryWriterInit(ctypes.byref(wrt))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(wrt)
    lib.WebPEncode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    try:
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise ValueError(f"libwebp fails to encode: error {pic.error_code}")
        return ctypes.string_at(wrt.mem, wrt.size)
    finally:
        lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterClear(ctypes.byref(wrt))
