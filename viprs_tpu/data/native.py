"""ctypes bridge to the native C++ data kernels (native/libviprs_native.so).

The reference's native layer is its C++/Cython e-step (which here became
JAX/XLA and Pallas kernels); this framework's native layer instead accelerates the
host-side data path: BED 2-bit decoding, block-LD accumulation, int8
quantization, and banded-LD packing. Every entry point has a NumPy fallback, so
the library is optional (build with `make -C native`).
"""

import ctypes
import logging
import os

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False


class _NativeLib:
    def __init__(self, cdll):
        self._cdll = cdll
        self.u8p = ctypes.POINTER(ctypes.c_uint8)
        self.f32p = ctypes.POINTER(ctypes.c_float)
        self.f64p = ctypes.POINTER(ctypes.c_double)
        self.i8p = ctypes.POINTER(ctypes.c_int8)
        self.i64p = ctypes.POINTER(ctypes.c_int64)

        cdll.bed_decode_variant.argtypes = [self.u8p, ctypes.c_int64,
                                            ctypes.c_int64, self.f64p]
        cdll.bed_decode_variant.restype = None

        cdll.ld_block_accumulate.argtypes = [self.f64p, ctypes.c_int64,
                                             ctypes.c_int64, self.f64p]
        cdll.ld_block_accumulate.restype = None

        cdll.quantize_int8.argtypes = [self.f64p, ctypes.c_int64, self.i8p]
        cdll.quantize_int8.restype = None

    def __getattr__(self, name):
        return getattr(self._cdll, name)


def _try_autobuild(src_dir):
    """Best-effort one-shot build of the native library (make -C native).

    A fresh checkout has only the C++ source; the data-path kernels are worth
    the ~2 s compile (OpenMP quantize/pack/decode are several times faster
    than the NumPy fallbacks at genome scale). Failures are silent — the
    fallbacks remain correct.
    """
    import subprocess
    try:
        subprocess.run(['make', '-C', src_dir, '-s'], timeout=120,
                       capture_output=True, check=True)
        return True
    except Exception as e:  # noqa: BLE001 — any failure means "use fallback"
        logger.debug("Native autobuild failed: %s", e)
        return False


def load_native():
    """Load libviprs_native.so, building it on first use if only the source is
    present; returns None (with a debug log) when unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    src_dir = os.path.join(here, 'native')
    candidates = [
        os.path.join(src_dir, 'libviprs_native.so'),
        os.path.join(os.path.dirname(__file__), 'libviprs_native.so'),
    ]
    if not any(os.path.exists(p) for p in candidates) \
            and os.path.exists(os.path.join(src_dir, 'Makefile')):
        _try_autobuild(src_dir)
    for path in candidates:
        if os.path.exists(path):
            try:
                _LIB = _NativeLib(ctypes.CDLL(path))
                logger.debug("Loaded native library from %s", path)
                return _LIB
            except OSError as e:
                logger.debug("Failed loading native library %s: %s", path, e)
    logger.debug("Native library not built; using NumPy fallbacks.")
    return None
