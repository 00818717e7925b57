"""EI log-likelihood-ratio scoring of continuous candidates: the port's
hand-written Hopper kernel and its plain PyTorch version.

Replaces the JAX package's only TPU kernel,
``hyperopt_tpu/ops/pallas_kernels.py:97-215`` (``_gmm_rows_kernel``
behind ``gmm_logpdf_rows``, and ``ei_scores`` = below minus above), and
takes the place of the XLA fusion of ``gmm_logpdf_cont_pre`` that the
reference's suggest path runs instead.  For one group of unquantized
continuous dims it computes, per candidate ``x [B, Dg, S]`` (natural
space)::

    llr = gmm_logpdf_cont_pre(x, below) - gmm_logpdf_cont_pre(x, above)

from :func:`~hyperopt_tpu_torch.ops.kernels.gmm_precompute`'s ``c1``,
``inv_s``, ``mu_inv_s`` ``[Dg, K]`` and ``c1max`` ``[Dg]`` of each
mixture (K may differ between them).  Stabilization follows the
reference's main path: shift every term by the static ``c1max`` in one
pass over K, and where the sum underflows (``sum > 1e-38`` fails) take
the largest shifted term instead.  The log-space Jacobian cancels, but
is applied on both sides as the reference does.

What bounds it on an H100: each term costs seven FP32 operations and one
``exp``.  The ``exp`` issues on the special-function units, 16 per clock
per SM against 128 FP32 lanes, so the kernel is bound by exp throughput;
the bytes (x read once, llr written once, [Dg, K] constants) are a
rounding error beside it.  The design is the simple one: one block per
(dim, tile of B*S candidates), the dim's constants staged through shared
memory in chunks of K, one thread per candidate looping over both
mixtures and reading ``x`` once.  Making it fast is later work.

On a CUDA tensor :func:`gmm_llr` launches the kernel (building it at
first use) or raises; it never falls back.  On a CPU tensor it runs the
plain version, which is also what the tests and ``chip_smoke.py`` hold
the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

__all__ = ["KERNEL", "gmm_llr", "gmm_llr_plain", "gmm_logpdf_cont_pre"]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the CUDA kernel of :func:`gmm_llr` (``launches`` counts its launches)
KERNEL = CudaKernel(
    "gmm_scores.cu", "gmm_llr_f32",
    [_P, _P,                    # x, logspace
     _P, _P, _P, _P, _I,        # below: c1, inv_s, mu_inv_s, c1max, K
     _P, _P, _P, _P, _I,        # above: the same
     _P, _I, _I, _I, _P],       # out, B, Dg, S, stream
)

_PRE_KEYS = ("c1", "inv_s", "mu_inv_s", "c1max")


def gmm_logpdf_cont_pre(x, pre, logspace):
    """Continuous truncated-GMM log-density at natural-space ``x [..., S]``
    under mixtures ``pre [..., K]`` (``c1max`` ``[...]``), with per-row
    ``logspace [...]``: one multiply + exp per [S, K] term, stabilized by
    the static ``c1max`` shift, falling back to the largest shifted term
    where the whole sum underflows."""
    ls = logspace[..., None]
    lat = torch.where(ls, torch.log(torch.clamp(x, min=1e-30)), x)
    z = lat[..., :, None] * pre["inv_s"][..., None, :] - pre["mu_inv_s"][..., None, :]
    c1max = pre["c1max"][..., None]
    terms = (pre["c1"] - c1max)[..., None, :] - 0.5 * z * z
    sm = torch.sum(torch.exp(terms), dim=-1)
    mx = torch.amax(terms, dim=-1)
    jac = torch.where(ls, lat, 0.0)
    ll = torch.where(sm > 1e-38, torch.log(torch.clamp(sm, min=1e-38)), mx)
    return c1max + ll - jac


def gmm_llr_plain(x, logspace, pre_b, pre_a):
    """The plain PyTorch version of the kernel: below minus above."""
    return gmm_logpdf_cont_pre(x, pre_b, logspace) - gmm_logpdf_cont_pre(x, pre_a, logspace)


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"gmm_llr: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"gmm_llr: {name} must be contiguous")


def gmm_llr(x, logspace, pre_b, pre_a):
    """EI log-likelihood ratios ``[B, Dg, S]`` of candidates ``x [B, Dg,
    S]`` (float32, natural space) for dims with ``logspace [Dg]`` (bool),
    under the below/above mixtures ``pre_b``/``pre_a`` (dicts holding at
    least ``c1``, ``inv_s``, ``mu_inv_s`` ``[Dg, K]`` and ``c1max``
    ``[Dg]``).  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if x.device.type != "cuda":
        return gmm_llr_plain(x, logspace, pre_b, pre_a)
    if x.dim() != 3:
        raise ValueError(f"gmm_llr: x must be [B, Dg, S], got {tuple(x.shape)}")
    B, Dg, S = x.shape
    dev = x.device
    _check("x", x, (B, Dg, S), torch.float32, dev)
    _check("logspace", logspace, (Dg,), torch.bool, dev)
    mix = []
    for side, pre in (("below", pre_b), ("above", pre_a)):
        k = pre["c1"].shape[-1]
        for name in _PRE_KEYS:
            shape = (Dg,) if name == "c1max" else (Dg, k)
            _check(f"{side} {name}", pre[name], shape, torch.float32, dev)
        if k < 1:
            raise ValueError(f"gmm_llr: the {side} mixture has no components")
        mix.append((*(pre[n].data_ptr() for n in _PRE_KEYS), k))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = KERNEL.fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), logspace.data_ptr(), *mix[0], *mix[1],
                 out.data_ptr(), B, Dg, S, stream)
    if err != 0:
        raise RuntimeError(f"gmm_llr: kernel launch failed with CUDA error {err}")
    KERNEL.launches += 1
    return out
