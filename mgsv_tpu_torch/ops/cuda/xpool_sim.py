"""X-Pool pooled similarity: the CUDA kernels and their plain versions.

`xpool_sim` replaces the Pallas TPU kernels of
mgsv_tpu/ops/pallas/xpool_sim_vjp.py, `_core_fwd` (forward) and `_core_bwd`
(its full VJP), behind one autograd Function; `xpool_sim_eval` replaces
mgsv_tpu/ops/pallas/xpool_sim.py::xpool_sim_fused, the corpus similarity of
an evaluation (the same forward at rate 0, no autograd).  Per (music m,
video v) pair

    p    = softmax_s(q_v . k_m[s] / sqrt(D), masked snippets -> -1e9)
    h    = LN2(p v_m Wout^T + bout)
    o    = LN3(h + drop_(m,v)(h Wlin^T + blin))
    sim  = <o / |o|, vhat_v>                                   -> [M, V]

with the linear branch's dropout mask drawn from the Philox stream (m, v)
of `seed` (ops/philox.py).  On a CUDA tensor both launch
csrc/xpool_sim_train.cu (built at first use, see runtime/kernels.py) or
raise; on a CPU tensor they run `xpool_sim_reference`, the plain PyTorch
version with the same masks (autograd differentiates it), and
`xpool_sim_eval_reference`, the same a block of tracks at a time.

Both passes apply Wout once per track (u_m = v_m Wout^T), not once per
pair: the least work.  A forward launch runs, a group of tracks at a time,
u^T on the wgmma GEMM core and the pair chain as one persistent wgmma
kernel fed by TMA, which writes one float per pair; its workspace (the
tf32 halves of Wlin, and of k and u^T for a group) stays under 256 MB
whatever M is (`forward_workspace_bytes`), and the wrapper allocates it.
The kernel source says what bounds it on the card and how it splits the
work.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.models.layers import BIG_NEG
from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.runtime import kernels

DIM = 256          # the kernel's tiles span a full row of D = 256 (for LayerNorm)
MAX_S = 256        # snippets: the score tile's columns
MAX_M = 65535      # musics: grid y of the forward launch
# tracks per evaluation launch: at most MAX_M, and a multiple of 16 so that
# every chunk of the [M, S] mask starts 16-byte aligned
M_CHUNK = MAX_M - MAX_M % 16


def xpool_sim_reference(q, k, v, mask, vhat, weights, rate: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's `_core_jax`): q, vhat [V, D],
    k, v [M, S, D], mask [M, S], weights (Wout, bout, g2, b2, Wlin, blin,
    g3, b3) in torch layout -> [M, V]; materializes [M, V, D]."""
    wout, bout, g2, b2, wlin, blin, g3, b3 = weights
    d = q.shape[-1]
    scores = torch.einsum("vd,msd->mvs", q, k) / math.sqrt(d)
    scores = torch.where(mask[:, None, :] != 0, scores, torch.full_like(scores, BIG_NEG))
    ctx = torch.einsum("mvs,msd->mvd", torch.softmax(scores, dim=-1), v)
    h = F.layer_norm(F.linear(ctx, wout, bout), (d,), g2, b2, 1e-5)
    lin = F.linear(h, wlin, blin)
    if rate > 0.0:
        lin = lin * philox.xpool_mask(seed, k.shape[0], q.shape[0], d, rate, device=q.device)
    o = F.layer_norm(h + lin, (d,), g3, b3, 1e-5)
    ohat = o * torch.rsqrt(torch.clamp((o * o).sum(-1, keepdim=True), min=1e-24))
    return torch.einsum("mvd,vd->mv", ohat, vhat)


def xpool_sim_eval_reference(q, k, v, mask, vhat, weights, block: int = 256) -> torch.Tensor:
    """Plain version of the evaluation kernel: `xpool_sim_reference` at rate
    0 over `block` tracks at a time, so [block, V, D] is the most it holds
    -> [M, V]."""
    return torch.cat([xpool_sim_reference(q, k[i:i + block], v[i:i + block],
                                          mask[i:i + block], vhat, weights)
                      for i in range(0, mask.shape[0], block)])


def check_supported(q, k, v, mask, vhat, weights) -> None:
    """Raise ValueError for inputs the CUDA kernels do not take (the device
    aside)."""
    tensors = (q, k, v, mask, vhat) + tuple(weights)
    for t in tensors:
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError("xpool_sim: the kernel takes float32 tensors on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("xpool_sim: tensors must be contiguous and 16-byte aligned")
    vc, d = q.shape
    m, s = mask.shape
    want = [(vc, DIM), (m, s, DIM), (m, s, DIM), (m, s), (vc, DIM),
            (DIM, DIM), (DIM,), (DIM,), (DIM,), (DIM, DIM), (DIM,), (DIM,), (DIM,)]
    got = [tuple(t.shape) for t in tensors]
    if got != want or not (1 <= s <= MAX_S and 1 <= m <= MAX_M and vc >= 1):
        raise ValueError(f"xpool_sim: unsupported shapes {got} (needs D={DIM}, "
                         f"S <= {MAX_S}, M <= {MAX_M})")


def _check(q, k, v, mask, vhat, weights) -> None:
    if q.device.type != "cuda":
        raise ValueError("xpool_sim: the kernels take CUDA tensors; on the CPU "
                         "use xpool_sim_reference")
    check_supported(q, k, v, mask, vhat, weights)


@functools.cache
def _launchers(device_index: int):
    """(forward, its workspace size, backward's workspace size, backward) C
    entry points, with the kernels' shared-memory limits set once on this
    device (call with it current)."""
    lib = kernels.load("xpool_sim_train")
    lib.mgsv_xpool_sim_init.restype = ctypes.c_int
    err = lib.mgsv_xpool_sim_init()
    if err != 0:
        raise RuntimeError(f"xpool_sim: CUDA error {err} in init on cuda:{device_index}")
    drop = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
    fwd = lib.mgsv_xpool_sim_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + drop
    sizes = []
    for size in (lib.mgsv_xpool_sim_fwd_workspace, lib.mgsv_xpool_sim_bwd_workspace):
        size.restype = ctypes.c_size_t
        size.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        sizes.append(size)
    bwd = lib.mgsv_xpool_sim_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 4 + drop
    return fwd, sizes[0], sizes[1], bwd


def forward_workspace_bytes(vc: int, m: int, s: int, device: torch.device) -> int:
    """Bytes of device workspace one forward launch over m tracks takes (at
    most 256 MB, or one track's more): Wlin's tf32 halves, then k's and
    u^T's of a group of tracks."""
    with torch.cuda.device(device):
        return 4 * int(_launchers(device.index)[1](vc, m, s))


def _forward(q, k, v, mask, vhat, weights, out, ws, rate, seed) -> int:
    """One launch of the forward into out [M, V]; returns the CUDA error."""
    (vc, d), (m, s) = q.shape, mask.shape
    with torch.cuda.device(q.device):
        fwd = _launchers(q.device.index)[0]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [t.data_ptr() for t in (q, k, v, mask, vhat) + tuple(weights) + (out, ws)]
        return fwd(*args, vc, m, s, d, *philox.kernel_args(rate, seed), stream)


def xpool_sim_fwd(q, k, v, mask, vhat, weights, rate: float = 0.0,
                  seed: int = 0) -> torch.Tensor:
    """The forward kernel alone: [M, V] float32, CUDA tensors only."""
    _check(q, k, v, mask, vhat, weights)
    (vc, d), (m, s) = q.shape, mask.shape
    out = q.new_empty(m, vc)
    ws = q.new_empty(forward_workspace_bytes(vc, m, s, q.device) // 4)
    err = _forward(q, k, v, mask, vhat, weights, out, ws, rate, seed)
    if err != 0:
        raise RuntimeError(f"xpool_sim: CUDA error {err} at launch")
    xpool_sim_fwd.launches += 1
    return out


xpool_sim_fwd.launches = 0


def xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate: float = 0.0, seed: int = 0):
    """The backward kernel alone: gradients of sum(g * sims) as (dq, dk, dv,
    dvhat, [dWout, dbout, dg2, db2, dWlin, dblin, dg3, db3]); CUDA tensors
    only.  Its plain version is autograd through `xpool_sim_reference`."""
    _check(q, k, v, mask, vhat, weights)
    (vc, d), (m, s) = q.shape, mask.shape
    if g.shape != (m, vc) or g.dtype != torch.float32 or g.device != q.device:
        raise ValueError(f"xpool_sim: cotangent {tuple(g.shape)} {g.dtype}, want ({m}, {vc})")
    g = g.contiguous()
    dq, dvhat = torch.empty_like(q), torch.empty_like(vhat)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    grads = [torch.empty_like(w) for w in weights]
    with torch.cuda.device(q.device):
        _, _, size, bwd = _launchers(q.device.index)
        ws = q.new_empty(int(size(vc, m, s)))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [t.data_ptr() for t in (q, k, v, mask, vhat) + tuple(weights)
                + (g, dq, dk, dv, dvhat) + tuple(grads) + (ws,)]
        err = bwd(*args, vc, m, s, d, *philox.kernel_args(rate, seed), stream)
    if err != 0:
        raise RuntimeError(f"xpool_sim_bwd: CUDA error {err} at launch")
    xpool_sim_bwd.launches += 1
    return dq, dk, dv, dvhat, grads


xpool_sim_bwd.launches = 0


class _XPoolSimFn(torch.autograd.Function):
    """Forward and backward kernels; saves only the inputs (the backward
    recomputes every per-pair intermediate)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, vhat, rate, seed, *weights):
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(q, k, v, mask, vhat, *weights)
        return xpool_sim_fwd(q, k, v, mask, vhat, weights, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, vhat, *weights = ctx.saved_tensors
        dq, dk, dv, dvhat, grads = xpool_sim_bwd(q, k, v, mask, vhat, weights, g,
                                                 ctx.rate, ctx.seed)
        return (dq, dk, dv, None, dvhat, None, None, *grads)


def xpool_sim(q, k, v, mask, vhat, weights, rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """[M, V] pooled cosine similarity, differentiable in every input but
    the mask.  A CPU tensor runs the plain version; a CUDA tensor launches
    the forward kernel (`xpool_sim_fwd.launches`) and, for the gradient, the
    backward kernel (`xpool_sim_bwd.launches`), or raises."""
    if q.device.type == "cpu":
        return xpool_sim_reference(q, k, v, mask, vhat, weights, rate, seed)
    return _XPoolSimFn.apply(q, k, v, mask, vhat, rate, seed, *weights)


def xpool_sim_eval(q, k, v, mask, vhat, weights) -> torch.Tensor:
    """[M, V] pooled cosine similarity at rate 0, for an evaluation's corpus
    (no autograd).  A CPU tensor runs `xpool_sim_eval_reference`; a CUDA
    tensor launches the forward kernel's rate-0 instantiation (no dropout
    code), once per M_CHUNK tracks (counted in `xpool_sim_eval.launches`,
    apart from `xpool_sim_fwd`'s), or raises."""
    if q.device.type == "cpu":
        return xpool_sim_eval_reference(q, k, v, mask, vhat, weights)
    (vc, d), (m, s) = q.shape, mask.shape
    out = q.new_empty(m, vc)
    ws = None
    for start in range(0, m, M_CHUNK):
        part = slice(start, start + M_CHUNK)
        _check(q, k[part], v[part], mask[part], vhat, weights)
        rows = out[part]
        if ws is None:       # the first part is the largest
            ws = q.new_empty(forward_workspace_bytes(vc, rows.shape[0], s, q.device) // 4)
        err = _forward(q, k[part], v[part], mask[part], vhat, weights, rows, ws, 0.0, 0)
        if err != 0:
            raise RuntimeError(f"xpool_sim_eval: CUDA error {err} at launch")
        xpool_sim_eval.launches += 1
    return out


xpool_sim_eval.launches = 0
