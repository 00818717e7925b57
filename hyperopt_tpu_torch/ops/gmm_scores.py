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

What bounds it on an H100: one ``exp`` per (candidate, component) term,
on the special-function units (16 per SM per clock), so the kernel can
reach its bound only if its inner loop issues at most 8 instructions per
term.  The kernel (``csrc/gmm_scores.cu``, whose head says how) spends 7
on the term itself: the exp is one ``ex2.approx`` of ``t * log2(e)``,
loads and loop control add under one more, the constants sit in
one ``float4`` per component in shared memory shared by several
candidates of a thread, and the max and the subnormal band leave the hot
loop for a second pass that only far-tail candidates take.  The
components of a candidate are split across ``k_lanes`` lanes whose
partial sums meet in a fixed shuffle order, so a small batch still fills
the card and the same inputs give the same bits; :func:`launch_config`
picks the split from the shape.

Tolerance against the plain version (:data:`KERNEL_RTOL`,
:data:`KERNEL_ATOL`).  The terms ``t`` round alike (``-fmad=false``);
the exp does not.  Its argument ``t * log2(e)`` is rounded to float32
(and ``log2(e)`` is too), a relative error of at most ``|t| * 7.4e-8``
in the term, and ``ex2.approx`` adds about ``2**-22``.  The terms that
carry a sum have ``|t| <= |ll| + log K`` on average (weighted by their
share), and a sum that does not fall back has ``|ll| <= 87.5``, so each
mixture's ``ll`` moves by at most ``(87.5 + log K) * 7.4e-8 + 2.4e-7``,
about ``7.4e-6`` at K = 5000; the llr, a difference of two, twice that.
Beside it stays the 1e-5 that the order of the K-sum and ``log``'s last
bits took before: ``atol`` 3e-5, ``rtol`` 1e-5.  Where a sum sits within
that error of the ``1e-38`` threshold the two may take different
branches, as any two summation orders may.

On a CUDA tensor :func:`gmm_llr` launches the kernel (building it at
first use) or raises; it never falls back.  On a CPU tensor it runs the
plain version, which is also what the tests and ``chip_smoke.py`` hold
the kernel against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import CudaKernel

__all__ = ["CONFIGS", "KERNEL", "KERNEL_ATOL", "KERNEL_RTOL", "gmm_llr", "gmm_llr_plain",
           "gmm_logpdf_cont_pre", "launch", "launch_config"]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the CUDA kernel of :func:`gmm_llr` (``launches`` counts its launches)
KERNEL = CudaKernel(
    "gmm_scores.cu", "gmm_llr_f32",
    [_P, _P,                    # x, logspace
     _P, _P, _P, _P, _I,        # below: c1, inv_s, mu_inv_s, c1max, K
     _P, _P, _P, _P, _I,        # above: the same
     _P, _I, _I, _I,            # out, B, Dg, S
     _I, _I, _P],               # k_lanes, rows, stream
)

#: the kernel against :func:`gmm_llr_plain` (derivation: module docstring)
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 3e-5

#: (k_lanes, rows) splits the kernel is compiled for, most candidates per
#: warp (32 / k_lanes * rows) first: on the H100 they serve B=4096, B=64
#: and B=1 at Dg=12, S=128 (PERF.md)
CONFIGS = ((1, 4), (2, 2), (32, 1))
_WARPS = 4  # warps per block, as in the kernel
_BLOCKS_PER_SM = 4  # fewest blocks per SM a split must give, where one can

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


@functools.lru_cache(maxsize=256)
def launch_config(n_cand, n_dims, n_sms):
    """``(k_lanes, rows)`` for ``n_cand`` candidates per dim over
    ``n_dims`` dims on a card of ``n_sms`` SMs: the split with the most
    candidates per warp that still gives every SM ``_BLOCKS_PER_SM``
    blocks, else the finest."""
    for g, r in CONFIGS:
        if -(-n_cand // (32 // g * r * _WARPS)) * n_dims >= _BLOCKS_PER_SM * n_sms:
            return g, r
    return CONFIGS[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(x, logspace, pre_b, pre_a, out, config):
    """One launch of the kernel at ``config`` (``(k_lanes, rows)``) on
    checked tensors, counting nothing; returns the CUDA error code."""
    B, Dg, S = x.shape
    mix = [(*(pre[n].data_ptr() for n in _PRE_KEYS), pre["c1"].shape[-1])
           for pre in (pre_b, pre_a)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return KERNEL.fn()(x.data_ptr(), logspace.data_ptr(), *mix[0], *mix[1],
                           out.data_ptr(), B, Dg, S, *config, stream)


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
    for side, pre in (("below", pre_b), ("above", pre_a)):
        k = pre["c1"].shape[-1]
        for name in _PRE_KEYS:
            shape = (Dg,) if name == "c1max" else (Dg, k)
            _check(f"{side} {name}", pre[name], shape, torch.float32, dev)
        if k < 1:
            raise ValueError(f"gmm_llr: the {side} mixture has no components")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    config = launch_config(B * S, Dg, _sm_count(dev.index if dev.index is not None
                                                 else torch.cuda.current_device()))
    err = launch(x, logspace, pre_b, pre_a, out, config)
    if err != 0:
        raise RuntimeError(f"gmm_llr: kernel launch failed with CUDA error {err}")
    KERNEL.launches += 1
    return out
