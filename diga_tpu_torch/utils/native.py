"""The C host ops of the data path: ctypes over ``csrc/host_ops.cpp``.

The port's own copy of ``diga_tpu/utils/native.py`` (:64-117): the uint8
labelId->trainId remap, the fused RGB->BGR mean-subtract and /128
normalize, the confusion histogram and the 256-bin label histogram, each
in one pass with no temporaries.  ``SegDataset.__getitem__`` routes the
uint8 remap and the normalize of a uint8 HWC RGB image through them.

The source is compiled at first use, ``g++ -O3 -fPIC -shared
-std=c++17``, into ``diga_tpu_torch/_build/libhost_ops.so`` (git ignores
the directory), again whenever the source is newer than the library, and
renamed into place atomically, as ``ops/native.py`` builds the CUDA
kernels.  A failed build raises with g++'s output: nothing falls back
quietly to numpy.  Every machine the port runs on has a host compiler
(nvcc needs one).  ``SegDataset`` loads the library when it is
constructed, on the caller's thread, so a failed build raises there and
not in a loader's worker thread.

The plain versions the tests hold the C ops against are the numpy forms
the data path keeps for every other input, ``label_maps.remap_labels``
and ``normalize.normalize_image``, and, for the two ops the data path does
not run, ``fast_hist_plain`` and ``label_histogram_plain`` here.  The C
normalize multiplies by 1/128 where numpy divides by 128: exact in f32,
so the two are bit-equal; a difference would mean the build picked up
fast-math.  ``fast_hist`` counts only predictions in ``[0, n_class)``
(the C rule); its plain version does the same.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host_ops.cpp")
LIBRARY = os.path.join(_PKG, "_build", "libhost_ops.so")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()  # the loaders' threads reach load() together


def build() -> str:
    """Compile the source into ``LIBRARY``; returns g++'s output, raises on failure."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.remap_u8.argtypes = [u8, u8, ctypes.c_size_t, u8]
    lib.normalize_bgr.argtypes = [u8, f32, ctypes.c_size_t, f32]
    lib.fast_hist.argtypes = [i32, i32, ctypes.c_size_t, ctypes.c_int, i64]
    lib.label_histogram_u8.argtypes = [u8, ctypes.c_size_t, i64]
    for fn in (lib.remap_u8, lib.normalize_bgr, lib.fast_hist, lib.label_histogram_u8):
        fn.restype = None
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if missing or older than its source."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY)
                    or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
                build()
            _lib = _bind(ctypes.CDLL(LIBRARY))
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def remap_u8(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """``lut[labels]`` for uint8 labels and a 256-entry uint8 LUT."""
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"remap_u8 needs a 256-entry LUT, got shape {lut.shape}")
    out = np.empty_like(labels)
    load().remap_u8(_ptr(labels, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), labels.size,
                    _ptr(lut, ctypes.c_uint8))
    return out


def normalize_bgr(rgb_uint8: np.ndarray, mean_bgr: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> float32 BGR HWC, ``(x - mean_bgr) / 128``, one pass."""
    rgb = np.ascontiguousarray(rgb_uint8)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"normalize_bgr needs a uint8 (H, W, 3) image, got "
                         f"{rgb.dtype} {rgb.shape}")
    mean = np.ascontiguousarray(mean_bgr, dtype=np.float32)
    if mean.shape != (3,):
        raise ValueError(f"normalize_bgr needs 3 channel means, got shape {mean.shape}")
    out = np.empty(rgb.shape, dtype=np.float32)
    load().normalize_bgr(_ptr(rgb, ctypes.c_uint8), _ptr(out, ctypes.c_float), rgb.size // 3,
                         _ptr(mean, ctypes.c_float))
    return out


def fast_hist(gt: np.ndarray, pred: np.ndarray, n_class: int) -> np.ndarray:
    """(n_class, n_class) int64 confusion counts over pixels with both the
    label and the prediction in ``[0, n_class)``."""
    gt = np.ascontiguousarray(np.asarray(gt).reshape(-1), dtype=np.int32)
    pred = np.ascontiguousarray(np.asarray(pred).reshape(-1), dtype=np.int32)
    if gt.size != pred.size:
        raise ValueError(f"fast_hist: {gt.size} labels vs {pred.size} predictions")
    hist = np.zeros((n_class, n_class), dtype=np.int64)
    load().fast_hist(_ptr(gt, ctypes.c_int32), _ptr(pred, ctypes.c_int32), gt.size, n_class,
                     _ptr(hist, ctypes.c_int64))
    return hist


def fast_hist_plain(gt: np.ndarray, pred: np.ndarray, n_class: int) -> np.ndarray:
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    mask = (gt >= 0) & (gt < n_class) & (pred >= 0) & (pred < n_class)
    return np.bincount(n_class * gt[mask] + pred[mask],
                       minlength=n_class ** 2).reshape(n_class, n_class)


def label_histogram(labels: np.ndarray) -> np.ndarray:
    """256-bin int64 histogram of a uint8 label map (the rare-class gate's counts)."""
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    counts = np.zeros((256,), dtype=np.int64)
    load().label_histogram_u8(_ptr(labels, ctypes.c_uint8), labels.size,
                              _ptr(counts, ctypes.c_int64))
    return counts


def label_histogram_plain(labels: np.ndarray) -> np.ndarray:
    return np.bincount(np.asarray(labels, dtype=np.uint8).reshape(-1), minlength=256)
