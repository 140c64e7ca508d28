"""GATv2 edge attention in one pass per edge order (port of
hydragnn_tpu/ops/gat_mp.py).

For each receiver row, over its real incident edges (flash-attention
style, no ``[E, H*F]`` tensor in device memory):

  z   = leaky_relu(xl[src] + xr[dst], slope)            [H*F] lanes
  e_h = sum over head h's F lanes of z * att             (per head)
  m   = max_e e,   d = sum_e exp(e - m),
  acc = sum_e exp(e - m) * b_e * xl[src]                (b: dropout bits)

The denominator ignores the dropout bits (softmax, then dropout): a
dropped real edge still counts in ``d``.  A row with no real edge returns
``m = -1e9`` (the reference's ``_NEG``), ``d = 0``, ``acc = 0``.  The
caller merges the self loop and normalises (models/gat.py) with ``m``
frozen: softmax is shift-invariant, so the backward treats ``m`` as a
constant and ignores its cotangent.  ``att`` is the ``[H, F]`` parameter
itself, not the reference's block-diagonal ``att_mat [H*F, H]`` (an MXU
device of the TPU); its gradient is ``d att`` directly.

Backward, with ``m`` frozen and ``p = exp(e - m[dst])`` recomputed per edge:

  de_h = p_h (b_h <ga[dst], xl[src]>_h + gd[dst, h])
  dz   = (de expanded over the head's F lanes * att) * leaky_relu'(z)
  pass R (receiver order):  dxr[dst] += dz;  d att += z_act * de (per lane)
  pass S (sender order, through ``sender_perm``):
                            dxl[src] += p b ga[dst] + dz

Three kernels, hand-written in CUDA C++ for Hopper (csrc/gat_mp.cu, built
by kernels/build.py): the forward, pass R (with its block-order partial
sum of ``d att``) and pass S, each with two routes chosen by width alike
(:func:`lane_route`); route 1 takes every path's widths, route 2 is the
first design.  Both forwards sum every logit over its head's lanes in
lane order, as :func:`edge_logits` does, so the kernel's ``m`` equals the
plain version's bit for bit; route 1 of the forward stages the xl rows of
``U`` edges (:func:`fwd_group`) with the next group's in flight, sums
their ``U * H`` logits on as many lanes at once, then folds the group
into the online softmax with one max and one rescale.  Route 1 of pass R
and pass S sums each head's logit and ``q`` across the warp's lanes,
each lane's slots of the head in order, then a fixed butterfly (offsets
16, 8, 4, 2, 1, done as a reduce-scatter), several edges' loads in
flight (pass R also keeps each lane's ``d att`` slots in registers over
its warp's rows).  The backward passes only read ``m`` (``p = exp(e -
m)``), so that other order moves ``p`` by a rounding of ``e``, within the
kernels' tolerance.

Each leaf takes a CPU tensor to its plain PyTorch version (the CPU path and
the tests' oracle) and a CUDA tensor to its kernel; a CUDA input the
kernel does not take raises.  ``LAUNCHES`` counts kernel launches per
kernel.  :func:`gat_edge_attention_reference` is the forward under
autograd: the reference the hand-written backward is held to.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from hydragnn_torch.ops.aggregate import segment_offsets
from hydragnn_torch.ops.fused_mp import _check_rc, _require

# Widest flat head-feature width (H*F) one kernel call takes; wider layers
# tile over balanced head groups (gat_edge_attention_tiled), the
# reference's limit, kept so that dispatch and launch counts match it
FUSED_HF_LIMIT = 1024

# the reference's sentinel: a row with no real edge reads m = -1e9
_NEG = -1e9

LAUNCHES: Dict[str, int] = {
    "gat_edge_attention": 0,
    "gat_edge_attention_pass_r": 0,
    "gat_edge_attention_pass_s": 0,
}

_MODES = {"gat_edge_attention": 0, "gat_edge_attention_pass_r": 1,
          "gat_edge_attention_pass_s": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_head_width_ok(f: int) -> bool:
    """The per-head width gate, reading this module's live limit, so that
    moving ``FUSED_HF_LIMIT`` moves the gate and the tiling together."""
    return f <= FUSED_HF_LIMIT


def _head_groups(h: int, f: int) -> List[int]:
    """Balanced head-group sizes with ``size * f <= FUSED_HF_LIMIT`` (6
    heads at cap 4 -> [3, 3], not [4, 2])."""
    assert f <= FUSED_HF_LIMIT, "single head exceeds the kernel width cap"
    gmax = max(1, FUSED_HF_LIMIT // f)
    n_groups = -(-h // gmax)
    base, rem = divmod(h, n_groups)
    return [base + 1] * rem + [base] * (n_groups - rem)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _valid_edges(edge_mask, senders, receivers, n):
    ok = (edge_mask != 0) & (senders >= 0) & (senders < n) \
        & (receivers >= 0) & (receivers < n)
    return ok, senders.clamp(0, n - 1).long(), receivers.clamp(0, n - 1).long()


def _leaky(z, slope):
    return torch.where(z > 0, z, z * slope)


def edge_logits(xs, xt, att, slope):
    """Per-head logits ``[E, H]`` of gathered rows ``xs = xl[src]``,
    ``xt = xr[dst]`` (``[E, H*F]``): ``sum_f leaky_relu(xs + xt) * att``,
    summed over each head's F lanes in lane order, as the kernels do.
    Returns ``(e, z, leaky_relu(z))``."""
    h, f = att.shape
    z = xs + xt
    zl = _leaky(z, slope)
    # [F, E, H]: each lane's products contiguous, added one lane at a time
    prod = (zl.reshape(-1, h, f) * att).permute(2, 0, 1).contiguous()
    e = prod[0]
    for k in range(1, f):
        e = e + prod[k]
    return e, z, zl


def _expand(v, f):
    """``[E, H] -> [E, H*F]``: each head's value over its F lanes."""
    return v.repeat_interleave(f, dim=1)


def gat_edge_attention_reference(xl, xr, att, senders, receivers, edge_mask,
                                 b_edge, slope):
    """The forward in plain PyTorch: ``(acc [N, H*F], m [N, H], d [N, H])``
    over real edges.  Differentiable under autograd in ``xl``, ``xr`` and
    ``att`` with ``m`` frozen (computed without gradient): the oracle of
    the hand-written backward.  ``b_edge`` None means ones."""
    n, hf = xl.shape
    h, f = att.shape
    ok, s, r = _valid_edges(edge_mask, senders, receivers, n)
    e, _, _ = edge_logits(xl[s], xr[r], att, slope)
    e = torch.where(ok[:, None], e, torch.full_like(e, _NEG))
    with torch.no_grad():
        m = torch.full((n, h), _NEG, dtype=e.dtype, device=e.device)
        m = m.scatter_reduce(0, r[:, None].expand(-1, h), e.detach(),
                             "amax", include_self=True)
    # masked edges: e = -1e9, so exp never overflows before the where
    p = torch.where(ok[:, None], torch.exp(e - m[r]), torch.zeros_like(e))
    d = torch.zeros((n, h), dtype=p.dtype, device=xl.device).index_add(
        0, r, p)
    pb = p if b_edge is None else p * b_edge
    acc = torch.zeros((n, hf), dtype=xl.dtype, device=xl.device).index_add(
        0, r, xl[s] * _expand(pb, f))
    return acc, m, d


def _backward_plain(xl, xr, att, senders, receivers, edge_mask, b_edge, m,
                    ga, gd, slope):
    """The per-edge terms both passes need, recomputed: ``(src, dst, p*b,
    de, dz, leaky_relu(z), ga[dst])``; p*b, de and dz are zero on masked
    edges."""
    n = xl.shape[0]
    h, f = att.shape
    ok, s, r = _valid_edges(edge_mask, senders, receivers, n)
    xs = xl[s]
    e, z, zl = edge_logits(xs, xr[r], att, slope)
    e = torch.where(ok[:, None], e, torch.full_like(e, _NEG))
    zero = torch.zeros((), dtype=xl.dtype, device=xl.device)
    p = torch.where(ok[:, None], torch.exp(e - m[r]), zero)
    pb = p if b_edge is None else p * b_edge
    gar = ga[r]
    q = (gar * xs).reshape(-1, h, f).sum(-1)
    # p, and with it p b and de, is exactly zero on masked edges, so dz
    # and both passes' sums are too
    de = torch.where(ok[:, None], pb * q + p * gd[r], zero)
    att_row = att.reshape(1, -1)
    dz = _expand(de, f) * torch.where(z > 0, att_row, att_row * slope)
    return s, r, pb, de, dz, zl, gar


def _pass_r(xr, att, terms):
    _, r, _, de, dz, zl, _ = terms
    h, f = att.shape
    dxr = torch.zeros_like(xr).index_add(0, r, dz)
    datt = (zl * _expand(de, f)).sum(0).reshape(h, f)
    return dxr, datt


def _pass_s(xl, att, terms):
    s, _, pb, _, dz, _, gar = terms
    contrib = _expand(pb, att.shape[1]) * gar + dz
    return torch.zeros_like(xl).index_add(0, s, contrib)


def gat_pass_r_plain(xl, xr, att, senders, receivers, edge_mask, b_edge, m,
                     ga, gd, slope):
    """Pass R written out: ``(dxr [N, H*F], d att [H, F])``."""
    return _pass_r(xr, att, _backward_plain(
        xl, xr, att, senders, receivers, edge_mask, b_edge, m, ga, gd, slope))


def gat_pass_s_plain(xl, xr, att, senders, receivers, edge_mask, b_edge, m,
                     ga, gd, slope):
    """Pass S written out: ``dxl [N, H*F]``."""
    return _pass_s(xl, att, _backward_plain(
        xl, xr, att, senders, receivers, edge_mask, b_edge, m, ga, gd, slope))


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


# route 1 of pass R and pass S: at most 8 slots of 32 lanes a head (F <=
# 256), 32 slots a lane in all and 16 heads
ROUTE1_MAX_SLOTS = 32
ROUTE1_MAX_HEADS = 16


def head_slots(f):
    """Slots of 32 columns that route 1 gives a head of width ``f``:
    ``ceil(f / 32)`` rounded up to 1, 2, 4 or 8; 0 past 8."""
    s = -(-f // 32)
    return next((t for t in (1, 2, 4, 8) if s <= t), 0)


def lane_route(hf, f):
    """The route of pass R and of pass S at these widths, as
    ``hg_gat_pass_r_route`` and ``hg_gat_pass_s_route`` decide it on the
    card: 1 where a head takes at most 8 slots, the ``hf / f`` heads at
    most 32 and there are at most 16 heads (the gat cell's 6 x 64 and
    gat_h256's head groups of 3 x 256 among them), else 2 (the first
    design)."""
    s, h = head_slots(f), hf // f
    return 1 if (s and h * s <= ROUTE1_MAX_SLOTS
                 and h <= ROUTE1_MAX_HEADS) else 2


# the three kernels share the rule
fwd_route = pass_r_route = pass_s_route = lane_route

# route 1's slots a lane for H heads of S slots: the counts the kernels
# are instantiated at (csrc/gat_mp.cu route1_nj), by S
_ROUTE1_NJ = {1: (4, 8, 16), 2: (4, 12, 16, 32), 4: (4, 8, 16, 32),
              8: (8, 24, 32)}

# the forward's route 1: the floats of a warp's stage at most (two groups'
# xl rows and the row's xr, H heads of the instantiation's widest head
# stride each; csrc/gat_mp.cu kFwdWarpFloats), so that four blocks of four
# warps fit a SM
FWD_WARP_FLOATS = 3456


def route1_nj(h, s):
    """The slots a lane that route 1 gives ``h`` heads of ``s`` slots: the
    smallest instantiated count >= ``h * s`` (0 past route 1)."""
    return next((c for c in _ROUTE1_NJ.get(s, ()) if c >= h * s), 0)


def fwd_group(hf, f):
    """U, the edges a group of the forward's route 1 takes, as
    ``hg_gat_fwd_group`` decides it: the most whose ``U * H`` logit chains
    take a lane each (H up to the instantiation's ``NJ / S`` heads) and
    whose two groups' staged xl rows, with the row's xr, fit
    ``FWD_WARP_FLOATS`` at the instantiation's widest head stride; 0 where
    the forward takes route 2.  3 at the gat cell's 6 x 64, 1 at
    gat_h256's 3 x 256."""
    if fwd_route(hf, f) != 1:
        return 0
    s = head_slots(f)
    heads = route1_nj(hf // f, s) // s
    by_smem = (FWD_WARP_FLOATS // (heads * (32 * s + 4)) - 1) // 2
    return max(1, min(by_smem, 32 // heads))


def launch_gat(op, xl, xr, att, senders, receivers, perm, row_ptr, b_edge,
               slope, m=None, ga=None, gd=None, route=0):
    """One launch of the GAT kernel in the mode ``op`` names, on a
    precomputed CSR schedule ``row_ptr`` (receiver order for the forward
    and pass R; sender order through ``perm`` for pass S).  ``route``: 0
    takes the widths' own (:func:`lane_route`), 1 or 2 asks for that one
    (the card checks time the first design beside route 1).  Returns:

    - ``gat_edge_attention``: ``(acc [N, H*F], m [N, H], d [N, H])``;
    - ``gat_edge_attention_pass_r``: ``(dxr [N, H*F], d att [H, F])``;
    - ``gat_edge_attention_pass_s``: ``dxl [N, H*F]``.
    """
    from hydragnn_torch.kernels.build import load_library

    dev = xl.device
    n, hf = xl.shape
    h, f = att.shape
    e = senders.shape[0]
    if h * f != hf or hf > FUSED_HF_LIMIT:
        raise ValueError(f"the GAT kernels take H*F <= {FUSED_HF_LIMIT} "
                         f"lanes matching att; got {hf} lanes, att {h}x{f}")
    if e >= 2**31 or n * hf >= 2**31:
        raise ValueError("the kernels index edges and rows with int32")
    _require(xl, "xl", torch.float32, (n, hf), dev)
    _require(xr, "xr", torch.float32, (n, hf), dev)
    _require(att, "att", torch.float32, (h, f), dev)
    _require(senders, "senders", torch.int32, (e,), dev)
    _require(receivers, "receivers", torch.int32, (e,), dev)
    _require(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    if b_edge is not None:
        _require(b_edge, "b_edge", torch.float32, (e, h), dev)
    mode = _MODES[op]
    partial = datt = m_out = d_out = None
    n_parts = 0
    if mode == 0:
        out = torch.empty((n, hf), dtype=torch.float32, device=dev)
        m_out = torch.empty((n, h), dtype=torch.float32, device=dev)
        d_out = torch.empty((n, h), dtype=torch.float32, device=dev)
    else:
        _require(m, "m", torch.float32, (n, h), dev)
        _require(ga, "dacc", torch.float32, (n, hf), dev)
        _require(gd, "dd", torch.float32, (n, h), dev)
        out = torch.empty((n, hf), dtype=torch.float32, device=dev)
    if mode == 1:
        # one d att partial per block, four blocks per SM
        n_parts = 4 * torch.cuda.get_device_properties(
            dev).multi_processor_count
        partial = torch.empty((n_parts, hf), dtype=torch.float32, device=dev)
        datt = torch.zeros((h, f), dtype=torch.float32, device=dev)
    if mode == 2:
        _require(perm, "sender_perm", torch.int32, (e,), dev)
    if route not in (0, 1, 2) or (route == 1 and lane_route(hf, f) != 1):
        raise ValueError(f"{op} takes route 0, 2, or 1 at its widths; got "
                         f"{route} at H*F={hf}, F={f}")
    if n > 0:
        lib = load_library("gat_mp")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.hg_gat_f32(
                mode, xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                senders.data_ptr(), receivers.data_ptr(), _ptr(perm),
                row_ptr.data_ptr(), _ptr(b_edge), _ptr(m), _ptr(ga),
                _ptr(gd), out.data_ptr(), _ptr(m_out), _ptr(d_out),
                _ptr(partial), _ptr(datt), n, hf, f, float(slope), n_parts,
                route, stream)
        _check_rc(rc, op)
        LAUNCHES[op] += 1
    if mode == 0:
        return out, m_out, d_out
    if mode == 1:
        return out, datt
    return out


# ---------------------------------------------------------------------------
# the op: the kernels on CUDA tensors, the plain versions on CPU tensors
# ---------------------------------------------------------------------------

def _sender_schedule(senders, edge_mask, sender_perm, n):
    p = sender_perm.long()
    return segment_offsets(senders[p], n, edge_mask[p])


class _GatEdgeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xl, xr, att, senders, receivers, sender_perm, edge_mask,
                b_edge, slope):
        ctx.slope = slope
        if not xl.is_cuda:
            acc, m, d = gat_edge_attention_reference(
                xl, xr, att, senders, receivers, edge_mask, b_edge, slope)
        else:
            acc, m, d = launch_gat(
                "gat_edge_attention", xl.contiguous(), xr.contiguous(),
                att.contiguous(), senders, receivers, None,
                segment_offsets(receivers, xl.shape[0], edge_mask),
                None if b_edge is None else b_edge.contiguous(), slope)
        ctx.save_for_backward(xl, xr, att, senders, receivers, sender_perm,
                              edge_mask, b_edge, m)
        ctx.mark_non_differentiable(m)
        return acc, m, d

    @staticmethod
    def backward(ctx, ga, _gm, gd):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "gat_edge_attention is not differentiable twice: its "
                "backward runs hand-written kernels")
        (xl, xr, att, senders, receivers, sender_perm, edge_mask, b_edge,
         m) = ctx.saved_tensors
        need = ctx.needs_input_grad
        slope = ctx.slope
        dxl = dxr = datt = None
        if not xl.is_cuda:
            # both passes' per-edge terms, recomputed once
            terms = _backward_plain(xl, xr, att, senders, receivers,
                                    edge_mask, b_edge, m, ga, gd, slope)
            if need[1] or need[2]:
                dxr, datt = _pass_r(xr, att, terms)
            if need[0]:
                dxl = _pass_s(xl, att, terms)
        else:
            n = xl.shape[0]
            xlc, xrc, attc = xl.contiguous(), xr.contiguous(), \
                att.contiguous()
            bc = None if b_edge is None else b_edge.contiguous()
            gac, gdc = ga.contiguous(), gd.contiguous()
            if need[1] or need[2]:
                dxr, datt = launch_gat(
                    "gat_edge_attention_pass_r", xlc, xrc, attc, senders,
                    receivers, None,
                    segment_offsets(receivers, n, edge_mask), bc, slope,
                    m, gac, gdc)
            if need[0]:
                dxl = launch_gat(
                    "gat_edge_attention_pass_s", xlc, xrc, attc, senders,
                    receivers, sender_perm,
                    _sender_schedule(senders, edge_mask, sender_perm, n),
                    bc, slope, m, gac, gdc)
        return (dxl if need[0] else None, dxr if need[1] else None,
                datt if need[2] else None, None, None, None, None, None,
                None)


def gat_edge_attention(xl, xr, att, senders, receivers, sender_perm,
                       edge_mask, b_edge, slope, f
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-side GATv2 attention partials — the reference's contract
    (hydragnn_tpu/ops/gat_mp.py:gat_edge_attention) with ``att [H, F]``.

    Returns ``(acc [N, H*F], m [N, H], d [N, H])`` over each receiver's
    real incident edges (see the module docstring); ``m`` carries no
    gradient and the caller must use it frozen.  ``b_edge [E, H]``: the
    dropout bits over keep (None: ones).  Differentiable once wrt ``xl``,
    ``xr`` and ``att``.  Requires nondecreasing ``receivers``,
    ``sender_perm`` the stable argsort of ``senders``, masked edges
    (``edge_mask == 0``) last in both orderings, and ``H*F <=
    FUSED_HF_LIMIT`` (callers tile wider layers)."""
    if att.shape[1] != f:
        raise ValueError(f"att is {tuple(att.shape)}, per-head width {f}")
    return _GatEdgeAttention.apply(xl, xr, att, senders, receivers,
                                   sender_perm, edge_mask, b_edge,
                                   float(slope))


def gat_edge_attention_tiled(xl, xr, att, senders, receivers, sender_perm,
                             edge_mask, b_edge, slope, f):
    """:func:`gat_edge_attention` tiled over the flat head-feature axis:
    above ``FUSED_HF_LIMIT`` the heads split into balanced groups (one
    kernel launch per group and pass, on column slices of ``xl``, ``xr``,
    ``att`` and ``b_edge``) and the outputs are concatenated back.
    Attention is independent per head, so the tiling changes launches,
    not math.  Within the limit this is exactly one untiled call."""
    h = att.shape[0]
    if h * f <= FUSED_HF_LIMIT:
        return gat_edge_attention(xl, xr, att, senders, receivers,
                                  sender_perm, edge_mask, b_edge, slope, f)
    accs, ms, ds = [], [], []
    h0 = 0
    for size in _head_groups(h, f):
        h1 = h0 + size
        cols = slice(h0 * f, h1 * f)
        acc, m, d = gat_edge_attention(
            xl[:, cols], xr[:, cols], att[h0:h1], senders, receivers,
            sender_perm, edge_mask,
            None if b_edge is None else b_edge[:, h0:h1], slope, f)
        accs.append(acc)
        ms.append(m)
        ds.append(d)
        h0 = h1
    return torch.cat(accs, 1), torch.cat(ms, 1), torch.cat(ds, 1)

