"""K3 and K4: the leaky-relu -> dilated conv -> bias (+ residual) step of the
HiFi-GAN MRF ResBlocks, forward and backward.

``mrf_conv`` is one ``torch.autograd.Function`` on both devices.  On the CPU
its forward and backward run the plain twins (:func:`mrf_conv_reference`,
:func:`mrf_conv_bwd_data_reference`, :func:`mrf_conv_bwd_weight_reference`);
on a CUDA tensor they launch the hand-written kernels ``csrc/mrf_conv.cu``
(K3), ``csrc/mrf_conv_bwd.cu`` (K4's data gradient) and
``csrc/mrf_conv_wgrad.cu`` (K4's weight gradient, whose split of the B*T sum
:func:`wgrad_plan` chooses per shape) or raise.
``mrf_conv.launches``, ``mrf_conv_bwd_data.launches`` and
``mrf_conv_bwd_weight.launches`` count kernel launches.

The backward twins are written as explicit formulas, not as autograd of
``F.conv1d``, so that the twin K4 is held against is itself held against
``jax.vjp`` of the JAX ResBlock math in the tests:

* ``dx = lrelu'(x) * conv_transpose1d(dy, w, dilation)`` (lrelu'(0) = 1);
* ``dw = conv1d_weight(lrelu(x), dy)``, ``db = sum dy``;
* ``d residual = dy``.

Every tensor may be fp32 or bf16, all of one dtype; bf16 (the s2 fine-tune
under ``is_half``) launches the kernels' bf16 instances, counted in
``launches_bf16``, and the twins round where the JAX Generator in bf16
rounds (generator.py:31-44; nn/layers.py ``leaky_relu``, WNConv1d): the
leaky relu to bf16 (``x * bf16(0.1)``), the conv (taken in fp32 from the
bf16 operands) to bf16, then the bias add and the residual add, each in
bf16; the data gradient's transposed conv to bf16, then ``da * bf16(0.1)``;
dW and db summed in fp32 and rounded to bf16 (XLA's bf16 reduction on the
CPU rounds its running sum, so the JAX package's db lands a few bf16 steps
off that exact sum).  A CUDA tensor of another dtype, or of mixed dtypes,
raises; nothing is cast to reach an instance.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.layers import LRELU_SLOPE, leaky_relu, weak_scalar, wide
from . import build

# K4's weight gradient (csrc/mrf_conv_wgrad.cu): the card it plans for
# (SMs of an H100 SXM), the most taps and the shared memory a block can use
WGRAD_SMS = 132
WGRAD_MAX_K = 15
WGRAD_SMEM = 227 * 1024
# threads of a wgmma block: three warpgroups, one tap each
WGRAD_WGMMA_THREADS = 384
# samples a stage on the bf16 wgmma route (csrc/mrf_conv_wgrad.cu TSB)
WGRAD_TS_BF16 = 128
# a larger cluster (fewer partial sums through scratch) is taken while its
# grid keeps this share of the largest grid that fits
WGRAD_FILL = 0.9


def _pad(k: int, dilation: int) -> int:
    return (k - 1) * dilation // 2


def mrf_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int,
                       residual: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain twin: conv1d(leaky_relu(x), w, dilation, same padding) + b
    (+ residual), the JAX ResBlock math (models/sovits/generator.py:31-44);
    in bf16 with its roundings."""
    if x.dtype != torch.bfloat16:
        y = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w, b,
                     padding=_pad(w.shape[-1], dilation), dilation=dilation)
        return y if residual is None else y + residual
    y = F.conv1d(leaky_relu(x).float(), w.float(),
                 padding=_pad(w.shape[-1], dilation),
                 dilation=dilation).to(x.dtype) + b[:, None]
    return y if residual is None else y + residual


def mrf_conv_bwd_data_reference(dy: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor,
                                dilation: int) -> torch.Tensor:
    """Plain twin of K4's data gradient:
    dx = lrelu'(x) * conv_transpose1d(dy, w, dilation, same padding)."""
    da = F.conv_transpose1d(wide(dy), wide(w),
                            padding=_pad(w.shape[-1], dilation),
                            dilation=dilation).to(dy.dtype)
    return torch.where(x >= 0, da, da * weak_scalar(LRELU_SLOPE, da.dtype))


def mrf_conv_bwd_weight_reference(dy: torch.Tensor, x: torch.Tensor,
                                  w_shape, dilation: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K4's weight gradient: (dw, db) with
    dw = conv1d_weight(lrelu(x), dy) and db = sum of dy over batch and time
    (bf16: summed in fp32, rounded)."""
    dw = torch.nn.grad.conv1d_weight(
        wide(leaky_relu(x)), tuple(w_shape), wide(dy),
        padding=_pad(w_shape[-1], dilation), dilation=dilation)
    return dw.to(dy.dtype), wide(dy).sum(dim=(0, 2)).to(dy.dtype)


# the kernels' instances: fp32, and bf16 (the s2 fine-tune under is_half)
MRF_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype or dtype not in MRF_DTYPES:
            raise ValueError(f"{name}: all tensors must be fp32, or all "
                             f"bf16, on one CUDA device")


def _entry(name: str, dtype: torch.dtype):
    """The library's entry point of ``name`` for ``dtype``, and the slope it
    takes: the leaky relu's, as JAX rounds it to the compute dtype."""
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    return (getattr(build.build(), f"{name}_{suffix}"),
            weak_scalar(LRELU_SLOPE, dtype))


def _count(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _check_shapes(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    cout, cin, k = w.shape
    if x.dim() != 3 or x.shape[1] != cin or k % 2 == 0:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _mrf_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   dilation: int,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on CUDA tensors (no autograd); see :func:`mrf_conv`."""
    tensors = [x, w, b] + ([residual] if residual is not None else [])
    _check_cuda("mrf_conv", *tensors)
    _check_shapes("mrf_conv", x, w)
    bsz, cin, t_len = x.shape
    cout, _, k = w.shape
    if b.shape != (cout,):
        raise ValueError(f"mrf_conv: bias must be ({cout},)")
    if residual is not None and residual.shape != (bsz, cout, t_len):
        raise ValueError("mrf_conv: residual must be (B, Cout, T)")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    residual = residual.contiguous() if residual is not None else None
    y = torch.empty((bsz, cout, t_len), dtype=x.dtype, device=x.device)
    fn, slope = _entry("ev_mrf_conv", x.dtype)
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), bsz, cin, cout, t_len, k, int(dilation), slope,
            _stream(x))
    build.check(rc, "mrf_conv")
    _count(mrf_conv, x.dtype)
    return y


def mrf_conv_bwd_data(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      dilation: int) -> torch.Tensor:
    """dx of K3 (dy: (B, Cout, T), x: the forward's input (B, Cin, T)); the
    plain twin on the CPU, K4 on CUDA."""
    if x.device.type == "cpu":
        return mrf_conv_bwd_data_reference(dy, x, w, dilation)
    _check_cuda("mrf_conv_bwd_data", dy, x, w)
    _check_shapes("mrf_conv_bwd_data", x, w)
    bsz, cin, t_len = x.shape
    cout, _, k = w.shape
    if dy.shape != (bsz, cout, t_len):
        raise ValueError("mrf_conv_bwd_data: dy must be (B, Cout, T)")
    dy, x, w = dy.contiguous(), x.contiguous(), w.contiguous()
    dx = torch.empty_like(x)
    fn, slope = _entry("ev_mrf_conv_bwd_data", x.dtype)
    rc = fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), bsz,
            cin, cout, t_len, k, int(dilation), slope, _stream(x))
    build.check(rc, "mrf_conv_bwd_data")
    _count(mrf_conv_bwd_data, x.dtype)
    return dx


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How K4's weight gradient cuts one shape.  An output tile is ``bn``
    output channels x ``bi`` input channels x ``taps`` taps: wgmma for
    ``bn`` in {64, 128} (``bi`` = 64, one tap a warpgroup; fp32 in 3xTF32,
    bf16 on bf16 tiles, ``ts`` samples a stage), mma.sync for ``bn`` in
    {16, 32} (``bi`` in {16, 32}, all k taps).  The B * ceil(T / ts) time
    tiles are cut into ``splits`` = cluster x clusters contiguous ranges;
    each tile's partial sums are added in rank order inside a cluster, then,
    when ``clusters`` > 1, in cluster order through ``scratch_floats``
    floats of scratch."""
    bn: int
    bi: int
    taps: int
    ts: int
    tiles: int
    time_tiles: int
    cluster: int
    clusters: int
    smem_bytes: int

    @property
    def splits(self) -> int:
        return self.cluster * self.clusters

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def part_floats(self) -> int:
        """Floats of one block's partial sums: the mma.sync tile, or the
        wgmma accumulators of its three warpgroups (one tap each), then
        db."""
        if self.bn <= 32:
            return self.bn * self.bi * self.taps + self.bn
        return self.bn // 2 * WGRAD_WGMMA_THREADS + self.bn

    @property
    def scratch_floats(self) -> int:
        if self.clusters == 1:
            return 0
        return self.clusters * self.tiles * self.part_floats

    def time_range(self, split: int) -> Tuple[int, int]:
        """The time tiles [first, end) that split ``split`` sums, as the
        kernel's ``Share`` computes them."""
        return (split * self.time_tiles // self.splits,
                (split + 1) * self.time_tiles // self.splits)


def nominal_clusters(bn: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks resident at once on a card of
    WGRAD_SMS SMs: one wgmma block (three warpgroups) or two mma.sync
    blocks an SM.  On the card the planner asks the runtime
    instead."""
    return WGRAD_SMS * (2 if bn <= 32 else 1) // cluster


def wgrad_plan(bsz: int, cin: int, cout: int, t_len: int, k: int,
               dilation: int,
               max_clusters: Optional[Callable[[int, int, int, int], int]]
               = None, dtype: torch.dtype = torch.float32,
               bn: Optional[int] = None) -> WgradPlan:
    """The tile and the split of the B*T sum for one shape, for the
    ``dtype`` instance (fp32 or bf16).  The tile is wgmma's where Cin and
    Cout are >= 64, else mma.sync's; ``bn`` (16 or 32: mma.sync, 64 or 128:
    wgmma) overrides the planner's width, as the design benches do.
    ``max_clusters(bn, bi, taps, cluster)`` is the number of such clusters
    the card holds at once (default :func:`nominal_clusters`).  The grid
    must fit on the card at once (a grid-wide barrier needs every block
    resident), with at most one split per time tile; of the cluster sizes
    8, 4, 2, 1 the largest whose grid is at least WGRAD_FILL of the largest
    grid that fits is taken (less scratch, one wave).  Raises ValueError for
    what the kernel does not take."""
    if k % 2 == 0 or not 1 <= k <= WGRAD_MAX_K or dilation < 1:
        raise ValueError(f"mrf_conv_bwd_weight: k={k} d={dilation}: the "
                         f"kernel takes odd k <= {WGRAD_MAX_K}, d >= 1")
    if bn is None:
        bn = (64 if cout <= 64 else 128) if cin >= 64 and cout >= 64 else \
            (16 if cout <= 16 else 32)
    if bn not in (16, 32, 64, 128):
        raise ValueError(f"mrf_conv_bwd_weight: no tile {bn} wide")
    low = dtype == torch.bfloat16
    halo = (k - 1) * dilation
    threads = WGRAD_WGMMA_THREADS
    if bn > 32:
        bi, ts = 64, (WGRAD_TS_BF16 if low else 64)
        groups = -(-k // (threads // 128))
        taps = -(-k // groups)
        tiles = -(-cin // bi) * -(-cout // bn) * groups
        part = 4 * (bn // 2 * threads + bn)
        if low:  # three dy stages, two of lrelu(x) and of raw x (bf16)
            rx = (ts + halo + 7 + 31) & ~31
            smem = max(2 * (3 * bn * ts + 4 * bi * rx), part)
        else:  # two stages of dy hi, lo and x (fp32), + db shares
            rx = (ts + halo + 6) & ~3
            ldx = rx + (4 - rx % 32) % 32
            smem = max(4 * 2 * (2 * bn * ts + bi * ldx), part + 4 * threads)
    else:  # two stages of dy and x (fp32, bf16 widened), or the partial sums
        bi = 16 if cin <= 16 else 32
        ts, taps = 128, k
        tiles = -(-cin // bi) * -(-cout // bn)
        rx = (ts + halo + 6) & ~3
        ldx = rx + (4 - rx % 32) % 32
        smem = 4 * max(2 * (bn * (ts + 4) + bi * ldx), bn * bi * k + bn)
    if smem > WGRAD_SMEM:
        raise ValueError(f"mrf_conv_bwd_weight: a halo of {halo} samples "
                         f"needs {smem} B of shared memory")
    time_tiles = bsz * -(-t_len // ts)
    if max_clusters is None:
        def max_clusters(bn, bi, taps, cluster):
            return nominal_clusters(bn, cluster)
    fits = {}  # cluster size -> clusters a tile
    for cluster in (8, 4, 2, 1):
        clusters = min(max_clusters(bn, bi, taps, cluster) // tiles,
                       time_tiles // cluster)
        if clusters >= 1:
            fits[cluster] = clusters
    most = max((c * n for c, n in fits.items()), default=1)
    cluster = next((c for c, n in fits.items()
                    if c * n >= WGRAD_FILL * most), 1)
    return WgradPlan(bn, bi, taps, ts, tiles, time_tiles, cluster,
                     fits.get(cluster, 1), smem)


def card_clusters(device: int, bn: int, bi: int, taps: int, k: int,
                  dilation: int, cluster: int, probe: bool = True,
                  bf16: bool = False) -> int:
    """Clusters of ``cluster`` blocks of this tile that CUDA ``device``
    holds at once: what a cooperative launch accepts (``probe``; the kernel
    is launched with no work while the runtime refuses the count as too
    large), or what ``cudaOccupancyMaxActiveClusters`` promises; of the
    bf16 instance with ``bf16``."""
    lib = build.build()
    query = (lib.ev_mrf_conv_bwd_weight_max_clusters_bf16 if bf16
             else lib.ev_mrf_conv_bwd_weight_max_clusters)
    with torch.cuda.device(device):
        n = query(bn, bi, taps, k, dilation, cluster, int(probe))
    if n < 0:
        raise RuntimeError(f"mrf_conv_bwd_weight: cluster query failed "
                           f"(CUDA error {-n}: {build.error_string(-n)})")
    return n


_card_clusters = functools.lru_cache(maxsize=None)(card_clusters)


def wgrad_card_plan(bsz: int, cin: int, cout: int, t_len: int, k: int,
                    dilation: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> WgradPlan:
    """:func:`wgrad_plan` of the ``dtype`` instance with the clusters that
    a cooperative launch on CUDA ``device`` accepts
    (:func:`card_clusters`)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    bf16 = dtype == torch.bfloat16
    return wgrad_plan(bsz, cin, cout, t_len, k, dilation,
                      lambda bn, bi, taps, cluster: _card_clusters(
                          index, bn, bi, taps, k, dilation, cluster, True,
                          bf16), dtype=dtype)


def mrf_conv_bwd_weight(dy: torch.Tensor, x: torch.Tensor, w_shape,
                        dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of K3; the plain twin on the CPU, K4 on CUDA (one launch:
    the B*T sum split as :func:`wgrad_plan` says, partial sums added in a
    fixed order)."""
    if x.device.type == "cpu":
        return mrf_conv_bwd_weight_reference(dy, x, w_shape, dilation)
    _check_cuda("mrf_conv_bwd_weight", dy, x)
    cout, cin, k = (int(s) for s in w_shape)
    bsz, t_len = x.shape[0], x.shape[-1]
    if (x.dim() != 3 or x.shape[1] != cin
            or dy.shape != (bsz, cout, t_len)):
        raise ValueError(f"mrf_conv_bwd_weight: bad shapes x"
                         f"{tuple(x.shape)} dy{tuple(dy.shape)} w{w_shape}")
    dev = x.device
    d = int(dilation)
    plan = wgrad_card_plan(bsz, cin, cout, t_len, k, d, dev, x.dtype)
    dy, x = dy.contiguous(), x.contiguous()
    dw = torch.empty((cout, cin, k), dtype=x.dtype, device=dev)
    db = torch.empty((cout,), dtype=x.dtype, device=dev)
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    fn, slope = _entry("ev_mrf_conv_bwd_weight", x.dtype)
    rc = fn(dy.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, bsz, cin,
            cout, t_len, k, d, slope, plan.bn, plan.bi, plan.taps,
            plan.cluster, plan.clusters, _stream(x))
    build.check(rc, "mrf_conv_bwd_weight")
    _count(mrf_conv_bwd_weight, x.dtype)
    return dw, db


class _MRFConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dilation, residual):
        ctx.dilation = dilation
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return mrf_conv_reference(x, w, b, dilation, residual)
        return _mrf_conv_cuda(x, w, b, dilation, residual)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            dx = mrf_conv_bwd_data(dy, x, w, ctx.dilation)
        if need_w or need_b:
            dw, db = mrf_conv_bwd_weight(dy, x, w.shape, ctx.dilation)
        dres = dy if ctx.has_residual and ctx.needs_input_grad[4] else None
        return dx, dw if need_w else None, db if need_b else None, None, dres


def mrf_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dilation: int,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, Cin, T) fp32 or bf16; w: (Cout, Cin, k) with k odd; b:
    (Cout,); residual: (B, Cout, T) or None, all of x's dtype.  Returns
    (B, Cout, T) in that dtype, differentiable in x, w, b and residual on
    both devices."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mrf_conv: no kernel for device {x.device}")
    return _MRFConv.apply(x, w, b, int(dilation), residual)


for _fn in (mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight):
    _fn.launches = 0
    _fn.launches_bf16 = 0
