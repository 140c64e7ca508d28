"""DimeNet++'s row-local post-interaction chain (port of
hydragnn_tpu/ops/row_mlp.py ``dimenet_post_mlp``).

    u  = silu(tri @ W_up)                       # no bias
    h  = x_ji + u
    for i in range(n_before):  h = h + silu(silu(h @ W1_i + b1_i) @ W2_i + b2_i)
    h  = silu(h @ W + b) + x_edge
    for i in range(n_after):   h = h + silu(silu(h @ W1_i + b1_i) @ W2_i + b2_i)

``wb`` is the flat ``(w_0, b_0, w_1, b_1, ...)`` list in chain order, the
weights ``[in, out]`` (pass ``Linear.weight.t()``), ``b_0`` None (lin_up
has no bias).  Rows are independent; ``tri [E, Din]``, ``x_ji``, ``x_edge
[E, H]``, Din and H at most 128 (the reference's gate).

Kernels hand-written in CUDA C++ for Hopper (csrc/row_mlp.cu, built by
kernels/build.py): the forward (the reference's ``_post_fwd``) walks the
L = 2 + 2 (n_before + n_after) layers on a tile of rows, by one of two
routes (:func:`fwd_route`): at Din, H <= 64 with at most three residual
pairs every weight stays in shared memory, each warp walks its own 16-row
tiles (:func:`fwd_tiles`) and the products run on the tensor cores in
3xTF32; past that, a block's tile of 32 rows is held in shared memory
and each layer's weight staged from L2 per tile, the products on the
CUDA cores.  The backward (``_post_vjp_bwd``) recomputes the chain per
tile and walks it backwards, writing d tri, d x_ji and d x_edge per row
and summing every dW and db into per-block partials of a persistent grid,
reduced in a fixed order.  The backward takes one of two routes by width
(:func:`bwd_route`): at Din, H <= 64 with at most three residual pairs
every weight stays in shared memory, the weight gradients in registers,
and the products run on the tensor cores in 3xTF32; past that, a tile's
weights are staged from L2 per layer and its products run on the CUDA
cores.  The backward written out is :func:`dimenet_post_mlp_bwd_plain`.

A CPU tensor takes the plain PyTorch versions (the CPU path and the tests'
oracle), a CUDA tensor the kernels; a CUDA input the kernels do not take
raises.  ``LAUNCHES`` counts the kernels' launches.  The op is
differentiable once: a double backward raises (the force term, ROADMAP
queue A3).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from hydragnn_torch.ops.egcl_mp import _ptr
from hydragnn_torch.ops.fused_mp import _check_rc, _require

ROW_MLP_LIMIT = 128

LAUNCHES: Dict[str, int] = {"dimenet_post_mlp": 0,
                            "dimenet_post_mlp_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def n_dense(n_before, n_after):
    return 2 + 2 * (n_before + n_after)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _chain(tri, x_ji, x_edge, n_before, n_after, wb):
    """The chain, returning ``(h, pre-activations, dense inputs)``."""
    ws, bs = wb[0::2], wb[1::2]
    pres: List[torch.Tensor] = []
    ins: List[torch.Tensor] = []

    def dense(k, v):
        ins.append(v)
        z = v @ ws[k]
        if bs[k] is not None:
            z = z + bs[k]
        pres.append(z)
        return z

    k = 0
    h = x_ji + F.silu(dense(k, tri)); k += 1
    for _ in range(n_before):
        t = F.silu(dense(k, h)); k += 1
        h = h + F.silu(dense(k, t)); k += 1
    h = F.silu(dense(k, h)) + x_edge; k += 1
    for _ in range(n_after):
        t = F.silu(dense(k, h)); k += 1
        h = h + F.silu(dense(k, t)); k += 1
    return h, pres, ins


def dimenet_post_mlp_reference(tri, x_ji, x_edge, n_before, n_after, *wb):
    """The composed chain; differentiable under autograd.  The forward
    kernel's plain version."""
    return _chain(tri, x_ji, x_edge, n_before, n_after, wb)[0]


def _dsilu(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def dimenet_post_mlp_bwd_plain(tri, x_ji, x_edge, g, n_before, n_after, *wb):
    """The backward written out: ``(d tri, d x_ji, d x_edge, [dw_k],
    [db_k])`` (``db_0`` None).  The backward kernel's plain version."""
    _, pres, ins = _chain(tri, x_ji, x_edge, n_before, n_after, wb)
    ws, bs = wb[0::2], wb[1::2]
    dws: List = [None] * len(ws)
    dbs: List = [None] * len(ws)

    def back(k, dpost):
        dz = dpost * _dsilu(pres[k])
        dws[k] = ins[k].t() @ dz
        if bs[k] is not None:
            dbs[k] = dz.sum(0)
        return dz @ ws[k].t()

    k = len(ws) - 1
    dh = g
    for _ in range(n_after):
        dt = back(k, dh); k -= 1
        dh = dh + back(k, dt); k -= 1
    dxe = dh
    dh = back(k, dh); k -= 1
    for _ in range(n_before):
        dt = back(k, dh); k -= 1
        dh = dh + back(k, dt); k -= 1
    dxji = dh
    return back(0, dh), dxji, dxe, dws, dbs


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def check_widths(din, h):
    if not (1 <= din <= ROW_MLP_LIMIT and 1 <= h <= ROW_MLP_LIMIT):
        raise ValueError(
            f"the row_mlp kernels take Din, H <= {ROW_MLP_LIMIT}, got "
            f"Din={din}, H={h}")


def pack_weights(wb, din, h, dev):
    """The kernels' packed weights ``[W_0 Din*H | W_1 H*H | ...]`` and
    biases ``[L, H]`` (row 0 zero), float32 and contiguous."""
    ws, bs = wb[0::2], wb[1::2]
    want = [(din if k == 0 else h, h) for k in range(len(ws))]
    if ([tuple(w.shape) for w in ws] != want or bs[0] is not None
            or any(b is None or tuple(b.shape) != (h,) for b in bs[1:])):
        raise ValueError(
            f"the chain's weights must have the shapes {want}, lin_up "
            f"without a bias and every other layer with one of ({h},)")
    w = torch.cat([x.reshape(-1) for x in ws])
    zero = torch.zeros(h, dtype=torch.float32, device=dev)
    b = torch.stack([zero if x is None else x for x in bs])
    return w.contiguous(), b.contiguous()


# the forward's route 1 (row_mlp_fwd_tc_kernel): Din, H up to this width,
# at most this many layers; 16 warps a block, each on its own 16-row tiles
TC_WIDTH = 64
TC_MAX_LAYERS = 8
FWD_TC_WARPS = 16
FWD_TC_ROWS = 16


def fwd_route(din, h, n_before, n_after):
    """The forward kernel's route at these widths, as
    ``hg_row_mlp_fwd_route`` decides it on the card: 1 (weights resident,
    each warp on its own 16-row tiles, tensor cores in 3xTF32) at Din, H <=
    64 with at most 8 layers (three residual pairs), the arch sweep's
    DimeNet (64, 64, 1, 2) among them; 2 (the first design) otherwise.
    Needs no library: it assumes the card's opt-in shared memory holds
    route 1's weights and its warps' running h (194 KB at 8 layers; the
    H100 opts in to 227 KB), which the C side also checks."""
    return 1 if (din <= TC_WIDTH and h <= TC_WIDTH
                 and n_dense(n_before, n_after) <= TC_MAX_LAYERS) else 2


def fwd_tiles(n_rows, n_parts):
    """Route 1's plan on ``n_rows`` rows with ``n_parts`` blocks at most
    (the launch passes the card's SM count): ``(grid, tiles)``, the grid
    ``min(n_parts, ceil(n_rows / 16))`` and ``tiles[(block, warp)]`` the
    ``(first row, rows)`` of each of that warp's 16-row tiles in the order
    it walks them: tile ``warp * grid + block``, then every ``16 * grid``
    after it, as ``row_mlp_fwd_tc_kernel`` takes them."""
    n_tiles = -(-n_rows // FWD_TC_ROWS)
    grid = min(n_parts, n_tiles)
    step = grid * FWD_TC_WARPS
    tiles = {(blk, w): [(t * FWD_TC_ROWS,
                         min(FWD_TC_ROWS, n_rows - t * FWD_TC_ROWS))
                        for t in range(w * grid + blk, n_tiles, step)]
             for blk in range(grid) for w in range(FWD_TC_WARPS)}
    return grid, tiles


def bwd_route(din, h, n_before, n_after):
    """The backward kernel's route at these widths on the current card: 1
    (weights resident, tensor cores), 2 (weights staged per tile, CUDA
    cores) or 0 (the states do not fit a block's shared memory)."""
    from hydragnn_torch.kernels.build import load_library

    return load_library("row_mlp").hg_row_mlp_bwd_route(din, h, n_before,
                                                         n_after)


def launch_row_mlp(op, tri, x_ji, x_edge, w, b, n_before, n_after, gout=None,
                   want=(True,) * 3, route=0):
    """One launch of the row_mlp kernel on packed weights: the forward
    ``dimenet_post_mlp`` returns ``out [E, H]``; the backward
    ``dimenet_post_mlp_bwd`` ``(d tri, d x_ji, d x_edge, wgrad)``, the first
    three None where ``want`` says so, ``wgrad`` the reduced ``[dW packed |
    db L*H]``.  ``route`` (the forward only): 0 takes the widths' own
    (:func:`fwd_route`), 1 or 2 asks for that one (the card checks time
    the first design beside route 1)."""
    from hydragnn_torch.kernels.build import load_library

    dev = x_edge.device
    e, h = x_edge.shape
    din = tri.shape[1]
    check_widths(din, h)
    _require(tri, "tri", torch.float32, (e, din), dev)
    _require(x_ji, "x_ji", torch.float32, (e, h), dev)
    _require(x_edge, "x_edge", torch.float32, (e, h), dev)
    L = n_dense(n_before, n_after)
    _require(w, "packed weights", torch.float32,
             (din * h + (L - 1) * h * h,), dev)
    _require(b, "packed biases", torch.float32, (L, h), dev)
    if e >= 2**31:
        raise ValueError("the kernel indexes rows with int32")
    lib = load_library("row_mlp")
    fwd = op == "dimenet_post_mlp"
    out = dtri = dxji = dxe = partial = wgrad = None
    # the forward's route-1 grid and the backward's: one block per SM
    n_parts = torch.cuda.get_device_properties(dev).multi_processor_count
    if fwd:
        if route not in (0, 1, 2) or (
                route == 1 and fwd_route(din, h, n_before, n_after) != 1):
            raise ValueError(f"the row_mlp forward takes route 0, 2, or 1 "
                             f"at its widths; got {route} at Din={din}, "
                             f"H={h}, {L} layers")
        out = torch.empty((e, h), dtype=torch.float32, device=dev)
    else:
        if route != 0:
            raise ValueError(f"{op} takes route 0")
        _require(gout, "dout", torch.float32, (e, h), dev)
        if bwd_route(din, h, n_before, n_after) == 0:
            raise ValueError(
                f"the row_mlp backward keeps {L} layers' states per row "
                f"tile; at Din={din}, H={h} they do not fit a block's "
                "shared memory")
        if want[0]:
            dtri = torch.empty((e, din), dtype=torch.float32, device=dev)
        if want[1]:
            dxji = torch.empty((e, h), dtype=torch.float32, device=dev)
        if want[2]:
            dxe = torch.empty((e, h), dtype=torch.float32, device=dev)
        size = lib.hg_row_mlp_wgrad_size(din, h, n_before, n_after)
        # a persistent grid, one partial per block (131 KB each at H = 64)
        partial = torch.empty((n_parts, size), dtype=torch.float32,
                              device=dev)
        wgrad = torch.empty((size,), dtype=torch.float32, device=dev)
    if e > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_row_mlp_f32(
                0 if fwd else 1, tri.data_ptr(), x_ji.data_ptr(),
                x_edge.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(gout),
                _ptr(out), _ptr(dtri), _ptr(dxji), _ptr(dxe), _ptr(partial),
                _ptr(wgrad), e, din, h, n_before, n_after, n_parts, route,
                stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    elif wgrad is not None:
        wgrad.zero_()
    if fwd:
        return out
    return dtri, dxji, dxe, wgrad


def unpack_wgrad(wgrad, din, h, n_before, n_after):
    """The backward's flat ``wgrad`` -> ``([dw_k [in, H]], [db_k [H]])``,
    views of ``wgrad`` (``db_0`` None)."""
    L = n_dense(n_before, n_after)
    nw = din * h + (L - 1) * h * h
    dws = [wgrad[:din * h].view(din, h)]
    dws += list(wgrad[din * h:nw].view(L - 1, h, h).unbind(0))
    db = wgrad[nw:nw + L * h].view(L, h)
    return dws, [None] + list(db[1:].unbind(0))


# ---------------------------------------------------------------------------
# the op: the kernels on a CUDA tensor, the plain versions on a CPU tensor
# ---------------------------------------------------------------------------

class _DimenetPostMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tri, x_ji, x_edge, n_before, n_after, *wb):
        ctx.n_before, ctx.n_after = n_before, n_after
        ctx.bias_none = [b is None for b in wb[1::2]]
        ctx.save_for_backward(tri, x_ji, x_edge,
                              *[x for x in wb if x is not None])
        if not x_edge.is_cuda:
            return dimenet_post_mlp_reference(tri, x_ji, x_edge, n_before,
                                              n_after, *wb)
        e, h = x_edge.shape
        w, b = pack_weights(wb, tri.shape[1], h, x_edge.device)
        return launch_row_mlp("dimenet_post_mlp", tri.contiguous(),
                              x_ji.contiguous(), x_edge.contiguous(), w, b,
                              n_before, n_after)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "dimenet_post_mlp is not differentiable twice: its backward "
                "runs a hand-written kernel; the double backward of the "
                "energy-gradient force term comes with ROADMAP queue A3")
        tri, x_ji, x_edge, *live = ctx.saved_tensors
        nb, na = ctx.n_before, ctx.n_after
        it = iter(live)
        wb = []
        for none in ctx.bias_none:
            wb.append(next(it))
            wb.append(None if none else next(it))
        need = ctx.needs_input_grad
        g = g.contiguous()
        if not x_edge.is_cuda:
            dtri, dxji, dxe, dws, dbs = dimenet_post_mlp_bwd_plain(
                tri, x_ji, x_edge, g, nb, na, *wb)
        else:
            din, h = tri.shape[1], x_edge.shape[1]
            w, b = pack_weights(wb, din, h, x_edge.device)
            dtri, dxji, dxe, wgrad = launch_row_mlp(
                "dimenet_post_mlp_bwd", tri.contiguous(), x_ji.contiguous(),
                x_edge.contiguous(), w, b, nb, na, g,
                want=(need[0], need[1], need[2]))
            dws, dbs = unpack_wgrad(wgrad, din, h, nb, na)
        out = [dtri if need[0] else None, dxji if need[1] else None,
               dxe if need[2] else None, None, None]
        for k, (dw, db) in enumerate(zip(dws, dbs)):
            w_, b_ = wb[2 * k], wb[2 * k + 1]
            out.append(dw.reshape(w_.shape) if need[5 + 2 * k] else None)
            out.append(db if b_ is not None and need[6 + 2 * k] else None)
        return tuple(out)


def dimenet_post_mlp(tri, x_ji, x_edge, n_before, n_after, *wb):
    """The InteractionPPBlock tail as one row-local pass — the reference's
    signature and contract (hydragnn_tpu/ops/row_mlp.py:dimenet_post_mlp).
    ``wb``: ``(w_0, b_0, ...)`` in chain order, weights ``[in, out]``,
    ``b_0`` None.  Differentiable once wrt tri, x_ji, x_edge and every w
    and b.  Din and H at most 128 on the card (callers gate)."""
    return _DimenetPostMlp.apply(tri, x_ji, x_edge, n_before, n_after, *wb)
