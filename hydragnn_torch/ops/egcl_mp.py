"""EGNN's fused EGCL interaction block (port of hydragnn_tpu/ops/egcl_mp.py
with the ``egcl`` spec of hydragnn_tpu/ops/fused_block.py).

  t0 = x[s] @ W0s + x[r] @ W0r + [radial, edge_attr] @ W0g + b0
  m  = relu(relu(t0) @ W1 + b1)                        -> agg[s]
  c  = tanh(relu(m @ Wc0 + bc0) @ wc1)   (equivariant) -> psum[s] += clip(diff * c, +-100)

``geo = [diff_normed (3), radial (1), edge_attr (A)]``, the one geometry
definition shared with the composed path (models/layers.edge_geometry).
``w0 [2F+1+A, H]`` is the composed path's concat kernel, split here by row
ranges into the sender, receiver and geometry parts; its gradient comes
back through the split.  Weights need no 128-lane packing on Hopper.

Three kernels, hand-written in CUDA C++ for Hopper (csrc/egcl_mp.cu, built
by kernels/build.py), none of which writes an ``[E, H]`` tensor to device
memory:

- forward (the reference's ``_fused_fwd``): sender order through
  ``sender_perm``, recompute the chain per edge tile, sum ``m`` and the
  three translation lanes into the sender rows.  Two routes by width
  (:func:`fwd_route`): pass S's route 1 with the forward's roles (each warp
  on one share of the sender rows in 16-edge tiles, :func:`pass_s_tiles`
  over the sender CSR; the front of the chain on the tensor cores), or the
  first design;
- pass P (``_bwd_p_kernel``): sender order, recompute, backpropagate the
  cotangents ``dagg[s]``, ``dpsum[s]`` and write ``dx`` of the sender side,
  the per-edge ``dgeo`` and the weight gradients (one float32 partial per
  thread block, reduced in a fixed order).  Two routes by width
  (:func:`pass_p_route`): the tensor cores in 3xTF32 with each block on
  one share of the sender rows (:func:`~hydragnn_torch.ops.aggregate.
  row_shares`) and the weight gradients in registers, job by job
  (:func:`pass_p_jobs`), or the first design;
- pass S (``_bwd_s_kernel``): receiver order, recompute, ``dx`` of the
  receiver side.  Two routes by width (:func:`pass_s_route`): pass P's
  tensor-core chain with each warp on one share of the receiver rows and
  16-edge tiles (:func:`pass_s_tiles`), or the first design.

The backward is written out by hand (see :func:`egcl_pass_p_plain`,
:func:`egcl_pass_s_plain`):

  dc = sum_j dtr_j diff_j;  ddiff = dtr * c;  dcp = dc (1 - c^2)
  dwc1 = v^T dcp;  du0 = wc1 dcp * (v > 0);  dWc0 = m^T du0;  dbc0 = sum du0
  du = (dagg[s] + du0 @ Wc0^T) * (m > 0);  dW1 = a^T du;  db1 = sum du
  dt0 = (du @ W1^T) * (a > 0);  dW0s = x[s]^T dt0, dW0r = x[r]^T dt0,
  dW0g = geo'^T dt0, db0 = sum dt0
  dgeo = [ddiff, dt0 @ W0g^T];  dx[s] += dt0 @ W0s^T;  dx[r] += dt0 @ W0r^T

(``dtr = dpsum[s]`` masked by the clip, which never binds:
``|diff_normed| < 1`` and ``|tanh| <= 1``.)  Masked edges (``em == 0``) sort
last in both edge orderings (collate guarantees it); they are never
visited and get exactly zero for every output and every gradient.

Each leaf takes a CPU tensor to its plain PyTorch version (the CPU path and
the tests' oracle) and a CUDA tensor to its kernel; a CUDA input the
kernel does not take raises.  ``LAUNCHES`` counts kernel launches per
kernel.  :func:`egcl_block_reference` is the composed version under
autograd: the reference the kernels are held to.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_torch.ops.fused_mp import _check_rc, _require

# the reference's structural limits (ops/egcl_mp.py): one 128-lane tile for
# F and H, and a geo payload (3 diff + 1 radial + A) of at most 127 lanes
EGCL_F_LIMIT = 128
EGCL_H_LIMIT = 128
EGCL_GEO_LIMIT = 127

LAUNCHES: Dict[str, int] = {
    "egcl_block": 0,
    "egcl_block_pass_p": 0,
    "egcl_block_pass_s": 0,
}

_MODES = {"egcl_block": 0, "egcl_block_pass_p": 1, "egcl_block_pass_s": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _valid_edges(em, senders, receivers, n):
    ok = (em != 0) & (senders >= 0) & (senders < n) & (receivers >= 0) \
        & (receivers < n)
    return ok, senders.clamp(0, n - 1).long(), receivers.clamp(0, n - 1).long()


def split_weights(w0, f):
    """A concat kernel ``[2F+G, H]`` -> its row ranges ``[:F]``,
    ``[F:2F]``, ``[2F:]``: here (sender, receiver, geometry) rows; the
    cgcnn block's (receiver, sender, edge-attribute) rows."""
    return w0[:f], w0[f:2 * f], w0[2 * f:]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _chain(equivariant, x, geo, w0, b0, w1, b1, wc0, bc0, wc1, send, recv):
    w0s, w0r, w0g = split_weights(w0, x.shape[1])
    t0 = x[send] @ w0s + x[recv] @ w0r + geo[:, 3:] @ w0g + b0
    a = torch.relu(t0)
    m = torch.relu(a @ w1 + b1)
    if not equivariant:
        return a, m, None, None
    v = torch.relu(m @ wc0 + bc0)
    c = torch.tanh(v @ wc1.reshape(-1, 1))
    return a, m, v, c


def egcl_block_reference(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0,
                         wc1, senders, receivers):
    """The composed block on raw weights: gather, edge MLP, coordinate
    gate, ``index_add_``.  Returns ``(agg [N, H], psum [N, 3] or None)``;
    differentiable under autograd in every float input.  Masked edges give exactly zero for every output
    and every gradient.  The forward kernel's plain version."""
    n = x.shape[0]
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    _, m, _, c = _chain(equivariant, x, geo, w0, b0, w1, b1, wc0, bc0, wc1,
                        send, recv)
    zero = torch.zeros((), dtype=m.dtype, device=x.device)
    m = torch.where(ok[:, None], m, zero)
    agg = torch.zeros((n, m.shape[1]), dtype=m.dtype,
                      device=x.device).index_add(0, send, m)
    if not equivariant:
        return agg, None
    tr = torch.clamp(geo[:, :3] * c, -100.0, 100.0)
    tr = torch.where(ok[:, None], tr, zero)
    psum = torch.zeros((n, 3), dtype=m.dtype,
                       device=x.device).index_add(0, send, tr)
    return agg, psum


def _backward_plain(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0, wc1,
                    senders, receivers, gagg, gpsum):
    """The chain recomputed and taken back to dt0: the intermediates both
    passes need."""
    n = x.shape[0]
    ok, send, recv = _valid_edges(em, senders, receivers, n)
    a, m, v, c = _chain(equivariant, x, geo, w0, b0, w1, b1, wc0, bc0, wc1,
                        send, recv)
    zero = torch.zeros((), dtype=m.dtype, device=x.device)
    diff = geo[:, :3]
    dm = torch.where(ok[:, None], gagg[send], zero)
    r = dict(ok=ok, send=send, recv=recv, a=a, m=m, v=v, zero=zero,
             ddiff=torch.zeros_like(diff))
    if equivariant:
        dtr = torch.where(ok[:, None], gpsum[send], zero)
        tr = diff * c
        dtr = torch.where((tr >= -100.0) & (tr <= 100.0), dtr, zero)
        r["ddiff"] = dtr * c
        r["dcp"] = (dtr * diff).sum(1, keepdim=True) * (1.0 - c * c)
        r["du0"] = torch.where(v > 0, r["dcp"] * wc1.reshape(1, -1), zero)
        dm = dm + r["du0"] @ wc0.t()
    r["du"] = torch.where(m > 0, dm, zero)
    r["dt0"] = torch.where(a > 0, r["du"] @ w1.t(), zero)
    return r


def egcl_pass_p_plain(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0,
                      wc1, senders, receivers, gagg, gpsum):
    """Pass P written out: ``(dw0, db0, dw1, db1, dwc0, dbc0, dwc1, dgeo,
    dx_sender)`` (the coordinate weights' grads None unless
    ``equivariant``), zero on masked edges."""
    r = _backward_plain(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0,
                        wc1, senders, receivers, gagg, gpsum)
    n, f = x.shape
    dt0, du, a, send, recv = r["dt0"], r["du"], r["a"], r["send"], r["recv"]
    dwc0 = dbc0 = dwc1 = None
    if equivariant:
        dwc1 = (r["v"].t() @ r["dcp"]).reshape(wc1.shape)
        dwc0 = r["m"].t() @ r["du0"]
        dbc0 = r["du0"].sum(0)
    w0s, _, w0g = split_weights(w0, f)
    dw0 = torch.cat([x[send].t() @ dt0, x[recv].t() @ dt0,
                     geo[:, 3:].t() @ dt0])
    dgeo = torch.where(r["ok"][:, None],
                       torch.cat([r["ddiff"], dt0 @ w0g.t()], 1), r["zero"])
    dx_s = torch.zeros((n, f), dtype=dt0.dtype,
                       device=x.device).index_add(0, send, dt0 @ w0s.t())
    return (dw0, dt0.sum(0), a.t() @ du, du.sum(0), dwc0, dbc0, dwc1, dgeo,
            dx_s)


def egcl_pass_s_plain(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0,
                      wc1, senders, receivers, gagg, gpsum):
    """Pass S written out: ``dx_receiver [N, F]``."""
    r = _backward_plain(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0,
                        wc1, senders, receivers, gagg, gpsum)
    n, f = x.shape
    dt0 = r["dt0"]
    _, w0r, _ = split_weights(w0, f)
    return torch.zeros((n, f), dtype=dt0.dtype, device=x.device).index_add(
        0, r["recv"], dt0 @ w0r.t())


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def check_widths(f, h, geo_dim):
    if f > EGCL_F_LIMIT or h > EGCL_H_LIMIT or geo_dim > EGCL_GEO_LIMIT \
            or geo_dim < 4:
        raise ValueError(
            f"the egcl kernels take F <= {EGCL_F_LIMIT}, H <= {EGCL_H_LIMIT} "
            f"and 4 <= geo lanes <= {EGCL_GEO_LIMIT}, got F={f}, H={h}, "
            f"geo={geo_dim}")


# pass P's route 1 (csrc/egcl_mp.cu tc::pass_p_tc_kernel): F and H, padded
# to 16, up to this; G' holds the gp geometry lanes and a ones column
EGCL_TC_WIDTH = 48
EGCL_TC_GEO = 16
EGCL_TC_WARPS = 8
EGCL_TC_JOBS = 4


def _round16(n):
    return (n + 15) // 16 * 16


def pass_p_jobs(f, h, gp, equivariant):
    """Route 1's weight-gradient jobs, in the order the kernel numbers them
    (warp ``w`` of a block takes jobs ``w``, ``w + 8``, ...): one per
    (product, 16-row tile of its A operand, half of its 16-column-padded
    H), each ``(phase, name, row0, col0, cols)``.  The products, by phase:
    0 ``m^T du0`` (dWc0) and ``G'^T du0`` (its ones row: dbc0), only when
    equivariant; 1 ``a^T du`` (dW1) and ``G'^T du`` (db1); 2 ``x[s]^T dt0``
    (dW0s), ``x[r]^T dt0`` (dW0r) and ``G'^T dt0`` (its first gp rows dW0g,
    its ones row db0).  ``G'`` has 16 columns: the gp geometry lanes, the
    ones column, zeros."""
    fp, hp = _round16(f), _round16(h)
    pairs = [(0, "wc0", hp), (0, "bc0", 16), (1, "w1", hp), (1, "b1", 16),
             (2, "w0s", fp), (2, "w0r", fp), (2, "w0g", 16)]
    jobs = []
    for phase, name, rows in pairs:
        if phase == 0 and not equivariant:
            continue
        for mt in range(rows // 16):
            for nh in range(2):
                jobs.append((phase, name, 16 * mt, nh * hp // 2, hp // 2))
    return jobs


def pass_p_route(f, h, gp, equivariant=True):
    """Pass P's route at these widths: 1 (the tensor-core kernel) at F, H <=
    48 and gp <= 15 with at most 4 jobs a warp (:func:`pass_p_jobs`), every
    instantiation md17's and oc22's paths launch; 2 (the first design)
    past that, H = 128 among them.  The C side (``hg_egcl_pass_p_route``)
    decides on the card and also checks that a block's shared memory holds
    route 1 (at most 211 KiB, which an H100's does); a card test holds the
    two together."""
    if (_round16(f) <= EGCL_TC_WIDTH and _round16(h) <= EGCL_TC_WIDTH
            and gp + 1 <= EGCL_TC_GEO
            and len(pass_p_jobs(f, h, gp, equivariant))
            <= EGCL_TC_WARPS * EGCL_TC_JOBS):
        return 1
    return 2


def pass_s_route(f, h, gp, equivariant=True):
    """Pass S's route at these widths: 1 (pass P's tensor-core chain in
    receiver order) at pass P's route-1 widths, F, H <= 48 and gp <= 15,
    every instantiation md17's and oc22's paths launch; 2 (the first
    design) past that.  The C side (``hg_egcl_pass_s_route``) decides on
    the card and also checks that a block's shared memory holds route 1;
    a card test holds the two together.  ``equivariant`` moves only that
    shared memory."""
    if (_round16(f) <= EGCL_TC_WIDTH and _round16(h) <= EGCL_TC_WIDTH
            and gp + 1 <= EGCL_TC_GEO):
        return 1
    return 2


def fwd_route(f, h, gp, equivariant=True):
    """The forward's route at these widths: 1 (pass S's route 1 with the
    forward's roles: each warp on one share of the sender rows, the front
    of the chain on the tensor cores) at pass P's route-1 widths, F, H <=
    48 and gp <= 15, every instantiation md17's and oc22's paths launch; 2
    (the first design) past that.  Mirrors ``hg_egcl_fwd_route``, which
    also checks that a block's shared memory holds route 1; a card test
    holds the two together."""
    return pass_s_route(f, h, gp, equivariant)


# the routes 1 of pass S and the forward: warps a block (one block per SM)
# and edges a tile
EGCL_PASS_S_WARPS = 12
EGCL_PASS_S_TILE = 16


def pass_s_tiles(row_ptr, n_warps):
    """The route-1 plan of pass S over a receiver CSR, and of the forward
    over a sender CSR: warp ``w`` of the ``n_warps`` (blocks times 12) owns
    the rows ``[b[w], b[w + 1])`` of
    :func:`~hydragnn_torch.ops.aggregate.row_shares` and walks their
    positions in 16-edge tiles (the forward maps a position to its edge
    through ``sender_perm``).  Returns ``(bounds, tiles)``, ``tiles`` a
    list per warp of ``(begin, end)`` position ranges in walking order."""
    from hydragnn_torch.ops.aggregate import row_shares

    bounds = row_shares(row_ptr, n_warps)
    ptr = row_ptr.long().cpu()
    tiles = []
    for w in range(n_warps):
        p0, p1 = int(ptr[int(bounds[w])]), int(ptr[int(bounds[w + 1])])
        tiles.append([(q, min(q + EGCL_PASS_S_TILE, p1))
                      for q in range(p0, p1, EGCL_PASS_S_TILE)])
    return bounds, tiles


def kernel_weights(equivariant, w0, b0, w1, b1, wc0, bc0, wc1, f, h, dev):
    """The nine contiguous float32 weight blocks the kernels take:
    ``(w0s, w0r, w0g, b0, w1, b1, wc0, bc0, wc1)`` (the last three None
    unless equivariant)."""
    gp = w0.shape[0] - 2 * f
    w0s, w0r, w0g = (t.contiguous() for t in split_weights(w0, f))
    out = [w0s, w0r, w0g, b0.contiguous(), w1.contiguous(), b1.contiguous()]
    shapes = [(f, h), (f, h), (gp, h), (h,), (h, h), (h,)]
    names = ["w0s", "w0r", "w0g", "b0", "w1", "b1"]
    if equivariant:
        out += [wc0.contiguous(), bc0.contiguous(),
                wc1.reshape(-1).contiguous()]
        shapes += [(h, h), (h,), (h,)]
        names += ["wc0", "bc0", "wc1"]
    for t, name, shape in zip(out, names, shapes):
        _require(t, name, torch.float32, shape, dev)
    return tuple(out) + (None,) * (9 - len(out))


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_egcl(op, equivariant, x, geo, weights, senders, receivers, perm,
                row_ptr, gagg=None, gpsum=None, want_dx=True,
                want_geo=False, route=0):
    """One launch of the EGCL kernel in the mode ``op`` names, on a
    precomputed CSR schedule ``row_ptr`` over positions (sender order
    through ``perm`` for the forward and pass P; receiver order, ``perm``
    None, for pass S).  ``route`` (the forward and pass S): 0 takes the
    widths' own (:func:`fwd_route`, :func:`pass_s_route`), 1 or 2 asks for
    that one (the card checks time the first design beside route 1).
    Returns:

    - ``egcl_block``: ``(agg [N, H], psum [N, 3] or None)``;
    - ``egcl_block_pass_p``: ``(wgrad, dgeo or None, dx_sender or None)``,
      ``wgrad`` the flat reduced weight gradients (see
      :func:`unpack_wgrad`);
    - ``egcl_block_pass_s``: ``dx_receiver``.
    """
    from hydragnn_torch.kernels.build import load_library

    dev = x.device
    n, f = x.shape
    e, geo_dim = geo.shape
    h = weights[4].shape[0]
    gp = geo_dim - 3
    check_widths(f, h, geo_dim)
    _require(x, "x", torch.float32, (n, f), dev)
    _require(geo, "geo", torch.float32, (e, geo_dim), dev)
    _require(senders, "senders", torch.int32, (e,), dev)
    _require(receivers, "receivers", torch.int32, (e,), dev)
    if perm is not None:
        _require(perm, "sender_perm", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    mode = _MODES[op]
    if route not in (0, 1, 2) or (route and mode == 1) or (
            route == 1 and pass_s_route(f, h, gp, equivariant) != 1):
        raise ValueError(f"{op} takes route 0, or for the forward and pass S "
                         f"2, or 1 at its widths; got {route} at F={f}, "
                         f"H={h}, gp={gp}")
    lib = load_library("egcl_mp")
    agg = psum = partial = wgrad = dgeo = out = None
    n_parts = 0
    if mode == 0:
        out = torch.empty((n, h), dtype=torch.float32, device=dev)
        if equivariant:
            psum = torch.empty((n, 3), dtype=torch.float32, device=dev)
    else:
        _require(gagg, "dagg", torch.float32, (n, h), dev)
        if equivariant:
            _require(gpsum, "dpsum", torch.float32, (n, 3), dev)
        if want_dx:
            out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if mode == 1:
        size = lib.hg_egcl_wgrad_size(f, h, gp, int(bool(equivariant)))
        # one partial per SM: at most ~264 KB each (F = H = 128)
        n_parts = torch.cuda.get_device_properties(dev).multi_processor_count
        partial = torch.empty((n_parts, size), dtype=torch.float32,
                              device=dev)
        wgrad = torch.empty((size,), dtype=torch.float32, device=dev)
        if want_geo:
            dgeo = torch.zeros((e, geo_dim), dtype=torch.float32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_egcl_f32(
                mode, int(bool(equivariant)), x.data_ptr(), geo.data_ptr(),
                senders.data_ptr(), receivers.data_ptr(), _ptr(perm),
                row_ptr.data_ptr(), *(_ptr(w) for w in weights),
                _ptr(gagg), _ptr(gpsum), _ptr(out), _ptr(psum),
                _ptr(partial), _ptr(wgrad), _ptr(dgeo), n, f, h, gp,
                n_parts, route, stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    elif mode == 1:
        wgrad.zero_()
    if mode == 0:
        agg = out
        return agg, psum
    if mode == 1:
        return wgrad, dgeo, out
    return out


def unpack_wgrad(equivariant, wgrad, f, h, gp):
    """Pass P's flat ``wgrad`` -> ``(dw0 [2F+gp, H], db0, dw1, db1, dwc0,
    dbc0, dwc1 [H, 1])`` (the last three None unless equivariant); views of
    ``wgrad``."""
    sizes = [2 * f + gp, 1, h, 1] + ([h, 1, 1] if equivariant else [])
    blocks = wgrad[:sum(sizes) * h].view(-1, h).split(sizes)
    dw0, db0, dw1, db1 = blocks[0], blocks[1][0], blocks[2], blocks[3][0]
    if not equivariant:
        return dw0, db0, dw1, db1, None, None, None
    return dw0, db0, dw1, db1, blocks[4], blocks[5][0], blocks[6].view(h, 1)


# ---------------------------------------------------------------------------
# the three passes: the kernel on a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def _sender_schedule(senders, em, sender_perm, n):
    p = sender_perm.long()
    return segment_offsets(senders[p], n, em[p])


class _EgclBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, equivariant, x, geo, w0, b0, w1, b1, wc0, bc0, wc1,
                senders, receivers, em, sender_perm):
        ctx.equivariant = equivariant
        ctx.save_for_backward(x, geo, w0, b0, w1, b1, wc0, bc0, wc1,
                              senders, receivers, em, sender_perm)
        if not x.is_cuda:
            agg, psum = egcl_block_reference(
                equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0, wc1,
                senders, receivers)
        else:
            n, f = x.shape
            ws = kernel_weights(equivariant, w0, b0, w1, b1, wc0, bc0, wc1,
                                f, w1.shape[0], x.device)
            agg, psum = launch_egcl(
                "egcl_block", equivariant, x.contiguous(), geo.contiguous(),
                ws, senders, receivers,
                sender_perm, _sender_schedule(senders, em, sender_perm, n))
        if psum is None:
            psum = torch.zeros((x.shape[0], 3), dtype=agg.dtype,
                               device=x.device)
            ctx.mark_non_differentiable(psum)
        return agg, psum

    @staticmethod
    def backward(ctx, gagg, gpsum):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "egcl_block is not differentiable twice: its backward runs "
                "hand-written kernels (the energy-gradient force term needs "
                "a double backward, which is not ported yet)")
        (x, geo, w0, b0, w1, b1, wc0, bc0, wc1, senders, receivers, em,
         sender_perm) = ctx.saved_tensors
        eq = ctx.equivariant
        need = ctx.needs_input_grad
        n, f = x.shape
        h = w1.shape[0]
        gagg = gagg.contiguous()
        gpsum = gpsum.contiguous() if eq else None
        grads = [None] * 14
        want_dx, want_geo = need[1], need[2]
        if not x.is_cuda:
            args = (eq, x, geo, em, w0, b0, w1, b1, wc0, bc0, wc1, senders,
                    receivers, gagg, gpsum)
            (dw0, db0, dw1, db1, dwc0, dbc0, dwc1, dgeo,
             dx) = egcl_pass_p_plain(*args)
            if want_dx:
                dx = dx + egcl_pass_s_plain(*args)
        else:
            ws = kernel_weights(eq, w0, b0, w1, b1, wc0, bc0, wc1, f, h,
                                x.device)
            xc, gc = x.contiguous(), geo.contiguous()
            wgrad, dgeo, dx_s = launch_egcl(
                "egcl_block_pass_p", eq, xc, gc, ws, senders, receivers,
                sender_perm, _sender_schedule(senders, em, sender_perm, n),
                gagg, gpsum, want_dx=want_dx, want_geo=want_geo)
            dw0, db0, dw1, db1, dwc0, dbc0, dwc1 = unpack_wgrad(
                eq, wgrad, f, h, geo.shape[1] - 3)
            dx = None
            if want_dx:
                dx_r = launch_egcl(
                    "egcl_block_pass_s", eq, xc, gc, ws, senders, receivers,
                    None, segment_offsets(receivers, n, em), gagg, gpsum)
                dx = dx_s + dx_r
        for i, d, like in ((1, dx, x), (2, dgeo, geo), (3, dw0, w0),
                           (4, db0, b0), (5, dw1, w1), (6, db1, b1),
                           (7, dwc0, wc0), (8, dbc0, bc0), (9, dwc1, wc1)):
            if need[i]:
                grads[i] = d.reshape(like.shape)
        return tuple(grads)


def egcl_block(equivariant, x, geo, em, w0, b0, w1, b1, wc0, bc0, wc1,
               senders, receivers, sender_perm
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused EGCL interaction block — the reference's signature and
    contract (hydragnn_tpu/ops/egcl_mp.py:egcl_block).

    ``m_e = relu(relu([x[s], x[r], geo_e[3:]] @ w0 + b0) @ w1 + b1)``, then
    ``agg[n] = sum_{e: s_e = n} m_e`` and (equivariant only) ``psum[n] =
    sum_{e: s_e = n} clip(diff_e * tanh(relu(m_e @ wc0 + bc0) @ wc1),
    +-100)``.  Returns ``(agg [N, H], psum [N, 3] or None)``; the caller
    divides psum by the sender degree.  Weights are ``[in, out]`` (pass
    ``Linear.weight.t()``); ``wc0``, ``bc0``, ``wc1`` are None unless
    equivariant.  Differentiable once wrt x, geo and every weight.
    Requires nondecreasing ``receivers``, ``sender_perm`` the stable
    argsort of ``senders``, masked edges (``em == 0``) last in both
    orderings, and the EGCL width limits (callers gate)."""
    agg, psum = _EgclBlock.apply(bool(equivariant), x, geo, w0, b0, w1, b1,
                                 wc0, bc0, wc1, senders, receivers, em,
                                 sender_perm)
    return agg, (psum if equivariant else None)
