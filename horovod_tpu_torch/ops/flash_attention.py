"""Flash attention: the port of ``horovod_tpu/ops/pallas_attention.py``.

Hand-written CUDA kernels for Hopper replace the three Pallas kernels of
the JAX package: the forward (``_fwd_kernel``), the dQ kernel
(``_dq_kernel``) and the dK/dV kernel (``_dkv_kernel``).  All three run on
the tensor cores (wgmma, ``csrc/flash_wgmma.cu``) for bfloat16 and float32
q/k/v alike; :func:`variant` names the instantiation a launch runs.  A
float32 operand reaches a kernel as bf16 planes, each the bf16 rounding of
what the planes before it leave (:func:`_split_plain`), made by one split
pass: :func:`split_qkv_cuda` splits float32 q/k/v into three planes (hi,
mid, lo) once per forward, kept for the backward's two kernels, and
:func:`split_do_cuda` a float32 dO once per backward, into three planes
beside float32 q/k/v and into two (hi, lo) beside bfloat16 q/k/v (the lse
variant's dO).  A product of two three-plane operands runs as six bf16
products (the plane pairs down to 2⁻¹⁶ of the term), which keeps fp32's
precision on bf16 tensor cores; two planes would not
(``tests/test_torch_flash_fp32.py``).  The kernels take any head dim that
is a multiple of 8 up to 256 (:func:`kernel_head_dim`).

Beside them stand their plain PyTorch versions, written as the explicit
formulas with fp32 sums:

* forward:  S = Q Kᵀ·scale, causal key j visible to query i iff j <= i,
  O = softmax(S) V, lse = logsumexp(S), as an online softmax over key
  blocks of ``FWD_BLOCK_K``;
* dQ:   P = exp(S - lse), dP = dO Vᵀ, dS = P ⊙ (dP - delta + dlse),
  dQ = dS K·scale, with delta = rowsum(dO ⊙ O);
* dK/dV:  dV = Pᵀ dO, dK = dSᵀ Q·scale.

They round where the Pallas kernels round, and so where the tensor cores
do: P to V's dtype before P·V, P to dO's dtype before Pᵀ·dO, dS to K's
dtype before dS·K and to Q's before dSᵀ·Q.  For fp32 inputs these casts do
nothing.  The bf16 forward rounds the unnormalised P = exp(S - m) against
the running row max m, which depends on the key blocks seen so far, so its
plain version walks the same key blocks as the kernel.

Which one runs depends only on where the tensors lie: CPU tensors take the
plain versions, CUDA tensors launch the kernels, and a kernel that cannot
take its input, fails to build or fails to launch raises.  There is no
fallback from the card to the plain versions.

Layout at the public functions is the JAX package's: q/k/v ``[B, S, H, D]``
and lse ``[B, S, H]``.  The kernels read ``[B, S, H, D]`` through strides,
so no head-major copy is made.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

# The widths the kernels are instantiated at (HVD_DISPATCH_D in
# csrc/flash_wgmma.cu).
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The wgmma forward's key tile (fwd_keys in csrc/flash_wgmma.cu) at head
# dims up to 128; see :func:`fwd_block_k`.
FWD_BLOCK_K = 128

# Launches of each kernel, counted where the wrapper launches it, and of
# each of its variants (see :func:`variant`; the split pass is "split",
# its variants "split" for a dO and "split qkv" for q, k and v).
launches = {"fwd": 0, "dq": 0, "dkv": 0, "split": 0}
variant_launches: Dict[str, int] = {}


def kernel_head_dim(D: int) -> int:
    """The instantiated width that serves head dim ``D``: the least of
    :data:`KERNEL_HEAD_DIMS` not below it.  The kernels read the columns
    from D to that width as zeros and write none of them.  D must be a
    multiple of 8 (a row of a contiguous bf16 tensor is then a whole number
    of the 16-byte units TMA moves) up to 256; any other raises."""
    if D <= 0 or D % 8 or D > KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"head dim {D} is not supported by the flash "
                         "kernels: it must be a multiple of 8 up to 256")
    return next(w for w in KERNEL_HEAD_DIMS if w >= D)


def fwd_block_k(D: int) -> int:
    """The wgmma forward's key tile at head dim ``D``: ``FWD_BLOCK_K``, and
    64 over 128, where the [64, D] output accumulator takes half the
    registers.  The plain forward walks the same blocks."""
    return FWD_BLOCK_K if D <= 128 else 64


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
    variant_launches.clear()


def variant(kernel: str, dtype: torch.dtype, do_dtype=None,
            causal: bool = True, out_f32: bool = False) -> str:
    """The compiled kernel a launch of ``kernel`` ("fwd", "dq" or "dkv")
    runs for q/k/v of ``dtype`` and dO of ``do_dtype``, e.g.
    ``"dq wgmma causal"`` (bf16), ``"fwd wgmma f32out"`` (bf16 q/k/v, fp32
    output: the lse variant's), ``"dkv wgmma f32do"`` (bf16 q/k/v with the
    lse variant's fp32 dO, split into bf16 planes) or ``"dq wgmma fp32"``
    (fp32 q/k/v as bf16 planes)."""
    bf16 = dtype == torch.bfloat16
    f32do = kernel != "fwd" and bf16 and do_dtype == torch.float32
    return " ".join([kernel, "wgmma"] + ["fp32"] * (not bf16)
                    + ["f32out"] * (bool(out_f32) and bf16)
                    + ["f32do"] * f32do + ["causal"] * bool(causal))


def _launched(kernel: str, name: str) -> None:
    launches[kernel] += 1
    variant_launches[name] = variant_launches.get(name, 0) + 1


# ---------------------------------------------------------------------------
# plain versions (fp32 math; they serve CPU tensors and are the oracle)
# ---------------------------------------------------------------------------


def _scores(q, k, scale, causal):
    """fp32 S = Q Kᵀ·scale as ``[B, H, Sq, Sk]``, masked keys at -inf."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _bsh(x):
    """``[B, H, S]`` statistics as contiguous ``[B, S, H]``."""
    return x.transpose(1, 2).contiguous()


def _bhs1(x):
    """``[B, S, H]`` statistics as ``[B, H, S, 1]`` for broadcasting."""
    return x.transpose(1, 2).unsqueeze(-1)


def _rounded(x, like):
    """fp32 ``x`` rounded to ``like``'s dtype, as an fp32 product operand."""
    return x.to(like.dtype).float()


def _flash_fwd_plain(q, k, v, scale: float, causal: bool,
                     out_f32: bool = False):
    """Masked softmax with its lse, ``(o [B,S,H,D], lse [B,S,H])``, as an
    online softmax over key blocks of :func:`fwd_block_k`: running max m,
    sum l of the fp32 P, and acc += round(P)·V per block."""
    s = _scores(q, k, scale, causal)
    m = torch.full(s.shape[:3] + (1,), float("-inf"), device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:3] + (q.shape[-1],), device=s.device)
    bk = fwd_block_k(q.shape[-1])
    for k0 in range(0, s.shape[-1], bk):
        sb = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        p = torch.exp(sb - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.einsum(
            "bhst,bthd->bhsd", _rounded(p, v),
            v[:, k0:k0 + bk].float())
        m = m_new
    o = (acc / l).transpose(1, 2)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(torch.float32 if out_f32 else q.dtype), _bsh(lse)


def _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal):
    p = torch.exp(_scores(q, k, scale, causal) - _bhs1(lse))
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    c = delta if dlse is None else delta - dlse
    return p, p * (dp - _bhs1(c))


def _flash_dq_plain(q, k, v, do, lse, delta, dlse, scale: float,
                    causal: bool):
    """dQ = Σ_k dS·K·scale with dS = P ⊙ (dO Vᵀ - delta + dlse)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal)
    dq = torch.einsum("bhst,bthd->bshd", _rounded(ds, k), k.float()) * scale
    return dq.to(q.dtype)


def _flash_dkv_plain(q, k, v, do, lse, delta, dlse, scale: float,
                     causal: bool):
    """dV = Σ_q Pᵀ·dO and dK = Σ_q dSᵀ·Q·scale."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal)
    dv = torch.einsum("bhst,bshd->bthd", _rounded(p, do), do.float())
    dk = torch.einsum("bhst,bshd->bthd", _rounded(ds, q), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _split_plain(x, n: int = 2):
    """An fp32 tensor as ``n`` bf16 planes: the first bf16(x), each next
    one the bf16 rounding of what the planes before it leave of x (each
    difference exact in fp32).  Two planes (hi, lo) hold x to about 2⁻¹⁷
    of it, three (hi, mid, lo) to about 2⁻²⁴."""
    planes, rest = [], x
    for _ in range(n):
        planes.append(rest.to(torch.bfloat16))
        rest = rest - planes[-1].float()
    return tuple(planes)


def _split_qkv_plain(q, k, v):
    """fp32 q, k and v as their three bf16 planes ``[3, 3, B, S, H, D]``
    (see :func:`_split_plain`), as :func:`split_qkv_cuda` lays them out."""
    return torch.stack([torch.stack(_split_plain(t, 3)) for t in (q, k, v)])


def rounding_slack(q, k, v, do, lse, delta, dlse, scale: float,
                   causal: bool):
    """Per element of ``o``, ``dq``, ``dk`` and ``dv``: how far a kernel
    may lie from the plain version because the two round an intermediate
    (P or dS) to bf16 from fp32 values that differ in their last bits (the
    sums run in other orders).  Where those values straddle a rounding
    boundary the two roundings differ by one bf16 ulp, at most 2⁻⁷ of the
    term.  Such flips are rare and independent, so over a sum y = Σ a·b
    they move y by far less than 2⁻⁷ times the root of Σ (a·b)², which is
    the slack: the largest term's ulp where one term dominates, and
    2⁻⁷·Σ|a·b|/√n where n terms share the sum evenly.  Zero where the
    intermediate is not rounded (fp32)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, dlse, scale, causal)

    def slack(a, b, eq, rounded_to, mult=1.0):
        if rounded_to.dtype == torch.float32:
            return torch.zeros((), device=a.device)
        return torch.einsum(eq, a.square(), b.float().square()).sqrt() * (
            2.0 ** -7 * mult)

    return {"o": slack(p, v, "bhst,bthd->bshd", v),
            "dq": slack(ds, k, "bhst,bthd->bshd", k, scale),
            "dk": slack(ds, q, "bhst,bshd->bthd", q, scale),
            "dv": slack(p, do, "bhst,bshd->bthd", do)}


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_qkv(q, k, v, do=None):
    """Raise on anything the kernels do not take.  ``dO`` may be float32
    where q is bfloat16: the gradient of the lse variant's fp32 output."""
    named = (("q", q), ("k", k), ("v", v)) + (() if do is None
                                              else (("dO", do),))
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype != q.dtype and not (name == "dO"
                                       and t.dtype == torch.float32):
            raise ValueError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"q has {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    kernel_head_dim(D)
    if B * S * H == 0:
        raise ValueError(f"empty input {tuple(q.shape)}")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"input of {q.numel()} elements exceeds the "
                         "kernels' 32-bit row indexing")
    return B, S, H, D


def _check_tma(*named):
    """The wgmma kernels load tiles through TMA tensor maps, and the split
    reads fp32 in 16-byte vectors: both take a 16-byte aligned base and
    (b, s, h) strides of whole 16-byte units."""
    for name, t in named:
        steps = [st * t.element_size() for st in t.stride()[:3]]
        if t.data_ptr() % 16 or any(st % 16 for st in steps):
            raise ValueError(
                f"{name} cannot be loaded by TMA: base address "
                f"{t.data_ptr():#x} and (b, s, h) strides of {steps} bytes "
                "must be multiples of 16 bytes")


def _check_stat(name, t, like):
    B, S, H, _ = like.shape
    if t.dtype != torch.float32 or t.shape != (B, S, H) or \
            not t.is_contiguous() or t.device != like.device:
        raise ValueError(f"{name} must be contiguous float32 [B, S, H] on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _strides(*ts):
    vals = [x for t in ts for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptrs(*ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash {name} kernel launch failed: CUDA error "
                           f"{err}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _split_cuda(name, n, *xs):
    """The split kernel over fp32 ``xs`` (checked, one shape, d contiguous,
    16-byte aligned): their ``n`` bf16 planes each, ``[len(xs), n, B, S, H,
    D]`` (see :func:`_split_plain`).  ``name``: the launch's variant."""
    from horovod_tpu_torch.ops import _build

    B, S, H, D = xs[0].shape
    lib = _build.lib()
    planes = torch.empty((len(xs), n, B, S, H, D), device=xs[0].device,
                         dtype=torch.bfloat16)
    with torch.cuda.device(xs[0].device):
        err = lib.hvd_flash_split(len(xs), _ptrs(*xs), _strides(*xs), B, S,
                                  H, D, n, planes.data_ptr(),
                                  _stream(xs[0].device))
    _launched("split", name)
    _raise_on(err, "split")
    return planes


def split_do_cuda(do, n: int = 2):
    """The split kernel on an fp32 dO: its ``n`` bf16 planes ``[n, B, S, H,
    D]`` (see :func:`_split_plain`): two for the wgmma kernels' f32do
    instantiations (bf16 q/k/v), three for their fp32 ones."""
    if not do.is_cuda or do.dtype != torch.float32 or do.dim() != 4:
        raise ValueError(f"the split takes a CUDA float32 [B, S, H, D] dO, "
                         f"got {do.dtype} {tuple(do.shape)} on {do.device}")
    kernel_head_dim(do.shape[-1])
    if do.numel() >= 2 ** 33:
        raise ValueError(f"dO of {do.numel()} elements is too large for the "
                         "split's 32-bit indexing")
    steps = [st * 4 for st in do.stride()[:3]]
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(st % 16
                                                        for st in steps):
        do = do.clone(memory_format=torch.contiguous_format)
    return _split_cuda("split", n, do)[0]


def split_qkv_cuda(q, k, v):
    """The split kernel on fp32 q, k and v, in one launch: their three bf16
    planes each, ``[3, 3, B, S, H, D]`` (see :func:`_split_qkv_plain`), for
    the wgmma forward's and dK/dV's fp32 instantiations."""
    _check_qkv(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"the split takes float32 q/k/v, got {q.dtype}")
    _check_tma(("q", q), ("k", k), ("v", v))
    return _split_cuda("split qkv", 3, q, k, v)


def _check_planes(name, planes, shape, like):
    if planes.shape != shape or planes.dtype != torch.bfloat16 or \
            not planes.is_contiguous() or planes.device != like.device:
        raise ValueError(f"{name} planes must be contiguous bf16 {shape} on "
                         f"{like.device}, got {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}")


def _kernel_qkv(q, k, v, planes):
    """The q/k/v tensors the kernels read, and their lower planes (q mid,
    q lo, k mid, k lo, v mid, v lo; None for bf16 q/k/v).  fp32 q/k/v go
    as their bf16 planes: ``planes`` where the caller split them
    (:func:`split_qkv_cuda`), else split here."""
    if q.dtype != torch.float32:
        _check_tma(("q", q), ("k", k), ("v", v))
        return (q, k, v), None
    if planes is None:
        planes = split_qkv_cuda(q, k, v)
    _check_planes("q/k/v", planes, (3, 3) + tuple(q.shape), q)
    return tuple(planes[:, 0]), [p for t in planes for p in t[1:]]


def flash_fwd_cuda(q, k, v, scale: float, causal: bool,
                   out_f32: bool = False, qkv_planes=None):
    """Forward kernel: ``(o [B,S,H,D], lse [B,S,H] fp32)``.
    ``qkv_planes``: fp32 q/k/v's planes from :func:`split_qkv_cuda`, so that
    the forward and the backward kernels share one split."""
    from horovod_tpu_torch.ops import _build

    B, S, H, D = _check_qkv(q, k, v)
    (qk, kk, vk), lo = _kernel_qkv(q, k, v, qkv_planes)
    lib = _build.lib()
    o = torch.empty((B, S, H, D), device=q.device,
                    dtype=torch.float32 if out_f32 else q.dtype)
    lse = torch.empty((B, S, H), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(),
            None if lo is None else _ptrs(*lo), o.data_ptr(),
            lse.data_ptr(), _strides(qk, kk, vk), B, S, H, D, float(scale),
            int(causal), _DTYPE_CODE[q.dtype], int(out_f32),
            _stream(q.device))
    _launched("fwd", variant("fwd", q.dtype, causal=causal, out_f32=out_f32))
    _raise_on(err, "forward")
    return o, lse


def do_planes_of(dtype: torch.dtype) -> int:
    """How many bf16 planes a wgmma backward kernel takes an fp32 dO in
    beside q/k/v of ``dtype``: three beside fp32, two beside bf16."""
    return 3 if dtype == torch.float32 else 2


def _bwd_args(q, k, v, do, lse, delta, dlse, do_planes, qkv_planes):
    """Checks the backward's inputs; returns ((B, S, H, D), the tensors of
    ``hvd_flash_dq``'s and ``hvd_flash_dkv``'s arguments up to ``dlse``
    (see :func:`_addresses`)).  An fp32 dO goes to the kernels as its bf16
    planes (:func:`do_planes_of`): ``do_planes`` where the caller split it
    already, else split here; fp32 q/k/v likewise (``qkv_planes``,
    :func:`_kernel_qkv`).  The caller holds the tensors until the launch:
    planes split here live only in them."""
    B, S, H, D = _check_qkv(q, k, v, do)
    _check_stat("lse", lse, q)
    _check_stat("delta", delta, q)
    if dlse is not None:
        _check_stat("dlse", dlse, q)
    do_lo = None
    if do.dtype == torch.float32:
        n = do_planes_of(q.dtype)
        planes = split_do_cuda(do, n) if do_planes is None else do_planes
        _check_planes("dO", planes, (n,) + tuple(q.shape), q)
        do, do_lo = planes[0], list(planes[1:])
    _check_tma(("dO", do))
    (qk, kk, vk), qkv_lo = _kernel_qkv(q, k, v, qkv_planes)
    if qkv_lo is None:  # bf16 q/k/v: an fp32 dO's lo plane on its own
        lo, do_lo = None, None if do_lo is None else do_lo[0]
    else:  # fp32: dO's mid and lo planes follow q/k/v's
        lo, do_lo = qkv_lo + do_lo, None
    return (B, S, H, D), (qk, kk, vk, lo, do, do_lo, lse, delta, dlse)


def _addresses(operands):
    """The backward kernels' operands (:func:`_bwd_args`) as their C entry
    points take them, and then the (b, s, h) strides of q, k, v and dO: a
    tensor as its address, a list of planes as an array of addresses, None
    as null."""
    args = [None if t is None else _ptrs(*t) if isinstance(t, list)
            else t.data_ptr() for t in operands]
    return args, _strides(*operands[:3], operands[4])


def flash_dq_cuda(q, k, v, do, lse, delta, dlse, scale: float,
                  causal: bool, do_planes=None, qkv_planes=None):
    """dQ kernel.  ``dlse`` may be None (the lse received no gradient).
    ``do_planes``: an fp32 dO's planes from :func:`split_do_cuda`, and
    ``qkv_planes`` fp32 q/k/v's from :func:`split_qkv_cuda`, so that dQ
    and dK/dV share one split of each."""
    from horovod_tpu_torch.ops import _build

    (B, S, H, D), operands = _bwd_args(q, k, v, do, lse, delta, dlse,
                                       do_planes, qkv_planes)
    args, strides = _addresses(operands)
    lib = _build.lib()
    dq = torch.empty((B, S, H, D), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_dq(*args, dq.data_ptr(), strides, B, S, H, D,
                               float(scale), int(causal),
                               _DTYPE_CODE[q.dtype], _stream(q.device))
    _launched("dq", variant("dq", q.dtype, do.dtype, causal))
    _raise_on(err, "dQ")
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, dlse, scale: float,
                   causal: bool, do_planes=None, qkv_planes=None):
    """dK/dV kernel: ``(dk, dv)``.  Arguments as for
    :func:`flash_dq_cuda`."""
    from horovod_tpu_torch.ops import _build

    (B, S, H, D), operands = _bwd_args(q, k, v, do, lse, delta, dlse,
                                       do_planes, qkv_planes)
    args, strides = _addresses(operands)
    lib = _build.lib()
    dk = torch.empty((B, S, H, D), device=q.device, dtype=k.dtype)
    dv = torch.empty((B, S, H, D), device=q.device, dtype=v.dtype)
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_dkv(*args, dk.data_ptr(), dv.data_ptr(), strides,
                                B, S, H, D, float(scale), int(causal),
                                _DTYPE_CODE[q.dtype], _stream(q.device))
    _launched("dkv", variant("dkv", q.dtype, do.dtype, causal))
    _raise_on(err, "dK/dV")
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"flash attention inputs on mixed devices: {devs}")


class _FlashAttention(torch.autograd.Function):
    """Custom backward running the two backward kernels (the port of the
    JAX package's ``_flash`` custom VJP).  Both outputs carry gradients:
    an lse cotangent adds the ``P·dlse`` term."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, out_f32):
        planes = None
        if _on_cpu(q, k, v):
            o, lse = _flash_fwd_plain(q, k, v, scale, causal, out_f32)
        else:
            # fp32 q/k/v are split once, for the forward and both backward
            # kernels.
            if q.dtype == torch.float32:
                planes = split_qkv_cuda(q, k, v)
            o, lse = flash_fwd_cuda(q, k, v, scale, causal, out_f32,
                                    qkv_planes=planes)
        ctx.save_for_backward(q, k, v, o, lse, planes)
        ctx.scale, ctx.causal = scale, causal
        # An output that received no gradient arrives as None, not zeros.
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, planes = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            dlse = dlse.float().contiguous()
        args = (q, k, v, do, lse, delta, dlse, ctx.scale, ctx.causal)
        if _on_cpu(q, k, v, do):
            dq = _flash_dq_plain(*args)
            dk, dv = _flash_dkv_plain(*args)
        else:
            # An fp32 dO (the lse variant's, or fp32 q/k/v's) is split once
            # for both kernels, and the forward's q/k/v planes serve both.
            do_planes = (split_do_cuda(do, do_planes_of(q.dtype))
                         if do.dtype == torch.float32 else None)
            dq = flash_dq_cuda(*args, do_planes=do_planes, qkv_planes=planes)
            dk, dv = flash_dkv_cuda(*args, do_planes=do_planes,
                                    qkv_planes=planes)
        return dq, dk, dv, None, None, None


def _run(q, k, v, causal, scale, out_f32):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 bool(out_f32))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise flash attention.  ``q/k/v``: [B, S, H, D].

    Returns the [B, S, H, D] context in q's dtype.  Differentiable; the
    backward runs the dQ and dK/dV kernels on the card."""
    o, _ = _run(q, k, v, causal, scale, out_f32=False)
    return o


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but returns the fp32 context and the
    per-query logsumexp ``[B, S, H]`` (fp32).  Both outputs carry
    gradients."""
    return _run(q, k, v, causal, scale, out_f32=True)
