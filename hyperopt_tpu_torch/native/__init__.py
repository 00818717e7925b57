"""ctypes loader of the native host-math library, compiled on first use.

The port's copy of :mod:`hyperopt_tpu.native`: ``tpe_math.cpp`` (the
truncated/quantized (log)GMM log-density and the adaptive-Parzen fit of
:mod:`hyperopt_tpu_torch.tpe_host`) is compiled with ``g++`` on first
use, bound through ctypes, and wrapped for numpy with the exact
semantics of the numpy oracle.  This is host code for the host TPE, not a
kernel of the card.

The library is built into the package's ``_build/`` directory, never
beside its source, under a name keyed by the platform, the CPU's flags
(``-march=native`` code must never load on another CPU) and the digest
of the source (a library built from an older source is never loaded).

``HYPEROPT_TPU_NATIVE`` means what it means to the reference: ``auto``
(the default) falls back to numpy when the build fails, ``0`` opts out,
and ``1`` is strict: after a failed build every call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sysconfig
import threading

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["available", "gmm_lpdf", "adaptive_parzen", "lib_path", "build"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tpe_math.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CXX = "g++"
_LOCK = threading.Lock()
_STATE = {"lib": None, "tried": False, "strict_error": None}


def _cpu_tag():
    """The CPU-capability token of the library's name: a digest of the
    cpuinfo flags line on Linux, 'generic' elsewhere."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    return "generic"


def _src_digest():
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


def lib_path():
    """Where the library for this source, platform and CPU is built."""
    tag = sysconfig.get_platform().replace("-", "_")
    return os.path.join(_BUILD_DIR, f"libtpe_math_{tag}_{_cpu_tag()}_{_src_digest()}.so")


def build(force=False):
    """Compile the shared library; returns its path or raises."""
    out = lib_path()
    if os.path.exists(out) and not force:
        return out  # the name carries the source's digest: never stale
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        _CXX, "-O3", "-std=c++17", "-shared", "-fPIC",
        # built on the machine that runs it (first-use build), so
        # -march=native is safe; -fno-math-errno lets gcc vectorize the
        # exp/erf loops via libmvec where available
        "-march=native", "-fno-math-errno", "-funroll-loops",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    logger.info("built native tpe_math: %s", out)
    return out


def _raise_strict():
    """Strict mode (=1) fails every caller, not just the first, with a
    fresh exception per call; the variable is read again, so setting it
    to 0 or auto after a strict failure restores the numpy fallback."""
    if os.environ.get("HYPEROPT_TPU_NATIVE", "auto") != "1":
        return None
    err = _STATE["strict_error"]
    raise RuntimeError(
        f"native tpe_math build failed under HYPEROPT_TPU_NATIVE=1: {err}"
    ) from err


def _load():
    # lock-free once resolved: this runs on every hot-path call.  "tried"
    # is published only after the outcome is in _STATE, so a caller racing
    # the first build waits on the lock instead of reading a half state.
    if _STATE["tried"]:
        if _STATE["strict_error"] is not None:
            return _raise_strict()
        return _STATE["lib"]
    with _LOCK:
        if _STATE["tried"]:
            if _STATE["strict_error"] is not None:
                return _raise_strict()
            return _STATE["lib"]
        mode = os.environ.get("HYPEROPT_TPU_NATIVE", "auto")
        if mode == "0":
            _STATE["tried"] = True
            return None
        try:
            lib = ctypes.CDLL(build())
        except Exception as e:
            if mode == "1":
                _STATE["strict_error"] = e  # cached: raised again per call
            _STATE["tried"] = True  # a broken toolchain is not rebuilt per call
            if mode == "1":
                raise
            logger.debug("native tpe_math unavailable: %s", e)
            return None

        # pointers bind as c_void_p so callers pass ``arr.ctypes.data``
        p = ctypes.c_void_p
        lib.ht_gmm_lpdf.argtypes = [
            p, ctypes.c_int64, p, p, p,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, p,
        ]
        lib.ht_gmm_lpdf.restype = None
        lib.ht_adaptive_parzen.argtypes = [
            p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64, p, p, p,
        ]
        lib.ht_adaptive_parzen.restype = ctypes.c_int64
        _STATE["lib"] = lib
        _STATE["tried"] = True
        return lib


def available():
    return _load() is not None


_F64 = np.dtype(np.float64)


def _as_c(a):
    """A C-contiguous float64 array (no copy when already one) and its
    raw data address."""
    if type(a) is np.ndarray and a.dtype == _F64 and a.flags.c_contiguous:
        return a, a.ctypes.data
    arr = np.ascontiguousarray(a, dtype=np.float64)
    return arr, arr.ctypes.data


def gmm_lpdf(x, w, mu, sigma, low=None, high=None, q=None, logspace=False):
    """Native truncated/quantized (log)GMM log-density; None if no lib."""
    lib = _load()
    if lib is None:
        return None
    x_arr, x_p = _as_c(np.atleast_1d(x))
    w_arr, w_p = _as_c(w)
    _mu_arr, mu_p = _as_c(mu)
    _sig_arr, sig_p = _as_c(sigma)
    out = np.empty(x_arr.shape[0], dtype=np.float64)
    lib.ht_gmm_lpdf(
        x_p, x_arr.shape[0], w_p, mu_p, sig_p, w_arr.shape[0],
        -np.inf if low is None else float(low),
        np.inf if high is None else float(high),
        0.0 if q is None else float(q),
        1 if logspace else 0,
        out.ctypes.data,
    )
    return out


def adaptive_parzen(mus, prior_weight, prior_mu, prior_sigma, lf):
    """Native adaptive-Parzen fit; None if no lib."""
    lib = _load()
    if lib is None:
        return None
    mus_arr, mus_p = _as_c(np.atleast_1d(np.asarray(mus, dtype=np.float64)))
    n = mus_arr.shape[0]
    m = n + 1
    w = np.empty(m)
    mu = np.empty(m)
    sig = np.empty(m)
    lib.ht_adaptive_parzen(
        mus_p, n, float(prior_weight), float(prior_mu), float(prior_sigma),
        int(lf or 0),
        w.ctypes.data, mu.ctypes.data, sig.ctypes.data,
    )
    return w, mu, sig
